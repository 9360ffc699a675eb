"""Viewer harness smoke test: serve, fetch state/frames, orbit reset."""

import json
import os
import threading
import urllib.request

import pytest


@pytest.fixture(scope="module")
def server(scenes_dir):
    import dataclasses
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.scene import load_p3f
    from distributionraytracer.viewer import make_server

    scene = load_p3f(os.path.join(scenes_dir, "balls_low.p3f"))
    scene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, res_x=24, res_y=24))
    httpd = None
    for port in range(18765, 18800):
        try:
            httpd = make_server(scene, RenderConfig(spp=1), port)
            break
        except OSError:
            continue
    assert httpd is not None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=300) as r:
        return r.read(), dict(r.headers)


def test_viewer_page_and_state(server):
    body, _ = _get(server, "/")
    assert b"distributionraytracer" in body
    body, _ = _get(server, "/state")
    st = json.loads(body)
    assert {"alpha", "beta", "r", "progressive"} <= set(st)


def test_viewer_progressive_frames_and_reset(server):
    b1, h1 = _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    assert b1[:4] == b"\x89PNG"
    assert float(h1["X-Samples"]) == 1.0
    _, h2 = _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    assert float(h2["X-Samples"]) == 2.0  # accumulating
    # camera motion resets the accumulator (FrameCount = 1)
    _, h3 = _get(server, "/frame?alpha=55&beta=20&r=3&progressive=1")
    assert float(h3["X-Samples"]) == 1.0
    # batch (non-progressive) frame works too
    b4, _ = _get(server, "/frame?alpha=55&beta=20&r=3&progressive=0")
    assert b4[:4] == b"\x89PNG"


def test_viewer_screenshot(server, tmp_path):
    # before any frame in this ordering frames already rendered by the
    # previous test; the endpoint saves the current accumulator
    _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    out = tmp_path / "shot.png"
    body, _ = _get(server, f"/screenshot?path={out}")
    meta = json.loads(body)
    assert meta["path"] == str(out)
    with open(out, "rb") as f:
        assert f.read(4) == b"\x89PNG"
    from distributionraytracer.utils.image import read_png
    img = read_png(str(out))
    assert img.shape == (24, 24, 3)


# ------------------------------------------------- interactive path tracer
@pytest.fixture(scope="module")
def pt_server():
    from distributionraytracer.config import RenderConfig
    from distributionraytracer.viewer import PTViewerState, make_server

    state = PTViewerState(0, RenderConfig(max_bounces=3), res=(32, 24),
                          chunk_spp=1)
    httpd = None
    for port in range(18800, 18840):
        try:
            httpd = make_server(None, None, port, state=state)
            break
        except OSError:
            continue
    assert httpd is not None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], state
    httpd.shutdown()


def test_pt_viewer_progressive_refinement(pt_server):
    """Component 24's real harness: the browser page drives the MC path
    tracer progressively (P3D_RT.html:1753-1783) — sample count grows
    frame to frame, resets on camera motion."""
    port, state = pt_server
    body, hdrs = _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    assert body[:4] == b"\x89PNG"
    assert float(hdrs["X-Samples"]) == 1.0
    _, hdrs = _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    assert float(hdrs["X-Samples"]) == 2.0
    # orbit move -> accumulator reset (w reset, P3D_RT.glsl:779-783)
    _, hdrs = _get(port, "/frame?alpha=60&beta=10&r=8.86&progressive=1")
    assert float(hdrs["X-Samples"]) == 1.0


def test_pt_viewer_screenshot(pt_server, tmp_path_factory):
    port, state = pt_server
    _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    p = tmp_path_factory.mktemp("pt") / "shot.png"
    body, _ = _get(port, f"/screenshot?path={p}")
    out = json.loads(body)
    assert out["path"] == str(p)
    assert p.exists() and p.stat().st_size > 100


def test_page_has_capture_and_pause_ui():
    """Viewer parity with the WebGL harness's capture extras
    (P3D_RT.html:2301-2342): webm recording (MediaRecorder over a canvas
    fed from each frame) and a pause/restart control."""
    from distributionraytracer.viewer import _PAGE
    assert "MediaRecorder" in _PAGE
    assert "capture.webm" in _PAGE
    assert "paused" in _PAGE and "toggleRecord" in _PAGE
    # restart = the reset route the 'r' key hits
    assert "/reset" in _PAGE
