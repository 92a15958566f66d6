"""Viewer frontend tests: the HTTP control surface drives a real progressive
render (GUI parity, SURVEY.md §2 #5) — start, poll, fetch image, stop."""
import json
import threading
import time
import urllib.request

import pytest

from raymarchrenderer.app.viewer import ViewerState, make_server


@pytest.fixture()
def server():
    srv = make_server(port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, srv.viewer_state
    srv.viewer_state.stop()
    srv.shutdown()
    srv.server_close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read()


def _post(base, path, obj=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def test_page_and_scene_listing(server):
    base, _ = server
    page = _get(base, "/").decode()
    assert "Render" in page and "canvas" in page
    scenes = json.loads(_get(base, "/api/scenes"))
    assert "sphere_on_floor" in scenes
    assert any(s.endswith("default.scene") for s in scenes)


def test_render_progress_and_image(server):
    base, state = server
    _post(base, "/api/render", {
        "scene": "sphere_on_floor", "spp": 3, "width": 32, "height": 32,
        "max_steps": 48, "max_bounces": 2, "max_dist": 100.0})
    deadline = time.time() + 120
    st = {}
    while time.time() < deadline:
        st = json.loads(_get(base, "/api/state"))
        if st["n"] >= 3 and not st["rendering"]:
            break
        time.sleep(0.3)
    assert st.get("error") == ""
    assert st["n"] == 3.0 and st["width"] == 32
    png = _get(base, "/api/image.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_stop_preserves_partial(server):
    base, state = server
    _post(base, "/api/render", {
        "scene": "sphere_on_floor", "spp": 500, "width": 32, "height": 32,
        "max_steps": 48, "max_bounces": 2, "max_dist": 100.0})
    deadline = time.time() + 120
    while time.time() < deadline:
        if json.loads(_get(base, "/api/state"))["n"] >= 1:
            break
        time.sleep(0.2)
    _post(base, "/api/stop")
    st = json.loads(_get(base, "/api/state"))
    assert not st["rendering"]
    assert st["n"] >= 1  # the partial accumulation survives (Escape parity)


def test_spectral_and_nee_render_modes(server):
    """The panel's spectral + direct-light toggles drive real renders
    (VERDICT r1: surface spectral/NEE in the viewer controls)."""
    base, state = server
    for req in ({"spectral": True}, {"direct_light": True}):
        _post(base, "/api/render", {
            "scene": "sphere_on_floor", "spp": 2, "width": 24,
            "height": 24, "max_steps": 48, "max_bounces": 2,
            "max_dist": 100.0, **req})
        deadline = time.time() + 120
        st = {}
        while time.time() < deadline:
            st = json.loads(_get(base, "/api/state"))
            if st["n"] >= 2 and not st["rendering"]:
                break
            time.sleep(0.3)
        assert st.get("error") == "", (req, st)
        assert st["n"] == 2.0, req


def test_camera_ops_restart_render(server):
    """`/api/camera` (Camera.cpp:104-137 intent): orbit/pan/zoom mutate the
    persistent pose and restart the progressive buffer; the next render
    uses the NEW pose, so the image changes."""
    import numpy as np

    from raymarchrenderer.io.image import load_png_bytes

    base, state = server
    req = {"scene": "sphere_on_floor", "spp": 2, "width": 32, "height": 32,
           "max_steps": 48, "max_bounces": 2, "max_dist": 100.0}
    _post(base, "/api/render", req)

    def wait_done():
        deadline = time.time() + 120
        while time.time() < deadline:
            st = json.loads(_get(base, "/api/state"))
            if st["n"] >= 2 and not st["rendering"]:
                return st
            time.sleep(0.2)
        raise AssertionError("render did not finish")

    st = wait_done()
    assert st["camera"] is not None and len(st["camera"]["eye"]) == 3
    img_a = load_png_bytes(_get(base, "/api/image.png"))
    eye0 = st["camera"]["eye"]

    r = json.loads(_post(base, "/api/camera",
                         {"op": "orbit", "ax": 0.4, "ay": 0.0}))
    assert r["ok"] and r["direction"] != [0.0, -0.4472135954999579,
                                          0.8944271909999159]
    st = wait_done()
    img_b = load_png_bytes(_get(base, "/api/image.png"))
    assert not np.array_equal(img_a, img_b), "orbit must change the image"

    r = json.loads(_post(base, "/api/camera", {"op": "zoom", "amount": 1.0}))
    assert r["ok"] and r["eye"] != eye0
    wait_done()

    r = json.loads(_post(base, "/api/camera", {"op": "reset"}))
    assert r["ok"] and r["eye"] == [0.0, 4.0, -6.0]
    st = wait_done()
    img_d = load_png_bytes(_get(base, "/api/image.png"))
    assert np.array_equal(img_a, img_d), "reset must restore the exact pose"


def test_camera_op_before_first_render_does_not_launch(server):
    """A pose op issued before ANY render must only move the camera: it
    must not start an unrequested render of the default scene (review
    finding: `camera_op` restarted from an empty `_last_req`, launching
    sphere_on_floor at the 512x512 defaults the user never asked for)."""
    base, state = server
    r = json.loads(_post(base, "/api/camera",
                         {"op": "orbit", "ax": 0.3, "ay": 0.1}))
    assert r["ok"] and len(r["eye"]) == 3
    time.sleep(0.3)
    st = json.loads(_get(base, "/api/state"))
    assert not st["rendering"] and st["n"] == 0
    assert state._thread is None, "camera op launched a render"
    # the moved pose IS used by the first real render
    req = {"scene": "sphere_on_floor", "spp": 1, "width": 16, "height": 16,
           "max_steps": 16, "max_bounces": 1, "max_dist": 100.0}
    _post(base, "/api/render", req)
    deadline = time.time() + 120
    while time.time() < deadline:
        st = json.loads(_get(base, "/api/state"))
        if st["n"] >= 1 and not st["rendering"]:
            break
        time.sleep(0.2)
    assert st["camera"]["eye"] == r["eye"]
