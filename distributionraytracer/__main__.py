from distributionraytracer.cli import main

main()
