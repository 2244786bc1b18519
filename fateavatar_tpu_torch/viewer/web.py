"""Interactive avatar viewer: a dependency-free web UI.

Port of ``fateavatar_tpu/viewer/web.py``. It replaces the reference's
dearpygui desktop viewer (tools/gui.py:153-708) with a stdlib http.server
app: a browser canvas with orbit-drag, expression and pose sliders, and
train/test-sequence autoplay, driving the avatar's forward on the card. A
web surface suits headless GPU hosts far better than a desktop GL window.

Camera convention matches the reference viewer: mouse orbit is realized as
a FLAME root-rotation offset, not a camera move (tools/gui.py:654-661).

The frame is one CUDA graph (``utils/graphs.Graph``), replayed per request
as ``Reenactor.reenact``'s served frame is: the UI state's expression,
pose, camera translation, field of view and background go into static
device tensors, and ``X-Device-Ms`` carries the replay's time (CUDA
events). Frames go out as the JAX package sends them: JPEG at quality 90
(``Content-Type: image/jpeg``), the bytes Pillow writes, from the port's
own encoder (``utils/jpeg.encode_jpeg``): the frame stays on the card for
its colour conversion, DCT and quantization, and only the coefficients
come to the host for the entropy coding.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from fateavatar_tpu_torch.utils.jpeg import encode_jpeg

_PAGE = """<!DOCTYPE html>
<html><head><title>fateavatar_tpu_torch viewer</title><style>
body { font-family: sans-serif; background: #181818; color: #eee;
       display: flex; gap: 16px; padding: 16px; }
#view { border: 1px solid #444; cursor: grab; }
.panel { width: 320px; }
label { display:block; font-size: 12px; margin-top: 8px; }
input[type=range] { width: 100%%; }
#fps { color: #8f8; font-size: 12px; }
button { margin-top: 8px; }
</style></head><body>
<div><canvas id="view" width="%(w)d" height="%(h)d"></canvas>
<div id="fps"></div></div>
<div class="panel">
  <h3>fateavatar_tpu_torch</h3>
  <div>drag to orbit &middot; wheel to zoom</div>
  <button id="play">play sequence</button>
  <button id="tracked">tracked params: off</button>
  <button id="canonical">canonical pose: off</button>
  <button id="reset">reset</button>
  <label>background
    <select id="bg"><option>white</option><option>black</option>
    <option>gray</option></select></label>
  <div id="sliders"></div>
</div>
<script>
const NEXP = %(n_exp)d;
let state = {yaw: 0, pitch: 0, zoom: 1, exp: new Array(NEXP).fill(0),
             jaw: 0, playing: false, frame: 0, tracked: false,
             fov: 0.8, neck: [0, 0, 0], bg: 'white', canonical: false};
const sliders = document.getElementById('sliders');
function addSlider(name, min, max, get, set, step) {
  const l = document.createElement('label');
  l.textContent = name;
  const s = document.createElement('input');
  s.type = 'range'; s.min = min; s.max = max;
  s.step = step || 0.01; s.value = get();
  s.oninput = () => { set(parseFloat(s.value)); dirty = true; };
  l.appendChild(s); sliders.appendChild(l);
}
// camera controls (tools/gui.py:276-360: FoV + orbit sliders)
addSlider('fov', 0.2, 1.4, () => state.fov, v => state.fov = v);
addSlider('frame', 0, 9999, () => state.frame,
          v => state.frame = Math.round(v), 1);
addSlider('jaw', 0, 0.5, () => state.jaw, v => state.jaw = v);
// neck rotation (tools/gui.py:386-401)
['neck x', 'neck y', 'neck z'].forEach((n, i) =>
  addSlider(n, -0.6, 0.6, () => state.neck[i], v => state.neck[i] = v));
for (let i = 0; i < Math.min(NEXP, 8); i++)
  addSlider('exp ' + i, -3, 3, () => state.exp[i], v => state.exp[i] = v);

const canvas = document.getElementById('view');
const ctx = canvas.getContext('2d');
let dragging = false, lastX = 0, lastY = 0, dirty = true;
canvas.onmousedown = e => { dragging = true; lastX = e.clientX; lastY = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  state.yaw += (e.clientX - lastX) * 0.01;
  state.pitch += (e.clientY - lastY) * 0.01;
  lastX = e.clientX; lastY = e.clientY; dirty = true;
};
canvas.onwheel = e => { state.zoom *= e.deltaY > 0 ? 1.05 : 0.95; dirty = true;
                        e.preventDefault(); };
document.getElementById('play').onclick = () => { state.playing = !state.playing; };
document.getElementById('tracked').onclick = e => {
  state.tracked = !state.tracked; dirty = true;
  e.target.textContent = 'tracked params: ' + (state.tracked ? 'on' : 'off');
};
// canonical-pose view: render the avatar's FLAME canonical exp/pose
// (the reference viewer's manual-mode default, tools/gui.py:186-190)
document.getElementById('canonical').onclick = e => {
  state.canonical = !state.canonical; dirty = true;
  e.target.textContent = 'canonical pose: ' + (state.canonical ? 'on' : 'off');
};
document.getElementById('bg').onchange = e => {
  state.bg = e.target.value; dirty = true; };
document.getElementById('reset').onclick = () => {
  state.yaw = 0; state.pitch = 0; state.zoom = 1;
  state.exp.fill(0); state.jaw = 0; dirty = true; };

let inflight = false;
async function tick() {
  if ((dirty || state.playing) && !inflight) {
    dirty = false; inflight = true;
    // pause-on-drag: autoplay holds the current frame while orbiting
    if (state.playing && !dragging) state.frame++;
    const t0 = performance.now();
    const r = await fetch('/render', {method: 'POST',
      body: JSON.stringify(state)});
    const devMs = r.headers.get('X-Device-Ms');
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    ctx.drawImage(img, 0, 0);
    document.getElementById('fps').textContent =
      (1000 / (performance.now() - t0)).toFixed(1) + ' fps (round-trip)' +
      (devMs ? ' · ' + parseFloat(devMs).toFixed(1) +
               ' ms device (' + (1000 / parseFloat(devMs)).toFixed(0) +
               ' fps)' : '');
    inflight = false;
  }
  requestAnimationFrame(tick);
}
tick();
</script></body></html>"""


def quantize(img):
    """A float [H, W, 3] frame as the uint8 the server sends: clipped to
    [0, 1], times 255, truncated (the JAX package's quantization). A tensor
    stays on its device; anything else becomes a numpy array."""
    if torch.is_tensor(img):
        return (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
    return (np.clip(np.asarray(img), 0, 1) * 255).astype("uint8")


class ViewerServer:
    """Serve the viewer for a render callback.

    ``render_fn(state: dict) -> [H, W, 3] float`` (a numpy array or a
    tensor on any device; or a pair with the device ms) receives the UI
    state: yaw, pitch, zoom, exp (list), jaw,
    neck, fov, bg, canonical, tracked, frame, playing. ``port=0`` takes a
    free port (``self.port`` after construction)."""

    def __init__(self, render_fn: Callable, width: int, height: int,
                 n_exp: int, port: int = 8090):
        self.render_fn = render_fn
        page = _PAGE % {"w": width, "h": height, "n_exp": n_exp}

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                state = json.loads(self.rfile.read(n) or b"{}")
                out = outer.render_fn(state)
                # render_fn may return (image, device_ms): the viewer shows
                # pure device render time next to the round-trip fps (the
                # reference's CUDA-event display, tools/gui.py:643-699)
                device_ms = None
                if isinstance(out, tuple):
                    out, device_ms = out
                body = encode_jpeg(quantize(out), 90)
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(body)))
                if device_ms is not None:
                    self.send_header("X-Device-Ms", f"{device_ms:.3f}")
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        print(f"viewer at http://localhost:{self.port}")
        self.httpd.serve_forever()

    def serve_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def make_avatar_render_fn(model, params, state, dataset=None,
                          camera_distance: float = 1.0,
                          render_cfg=None, tables=None):
    """Build the render callback for a FateAvatar on the device of
    ``params``: mouse orbit as FLAME root rotation (tools/gui.py:654-661),
    slider-driven jaw / neck / expression, zoom, fov and background, the
    canonical-pose view, and dataset autoplay (play_step,
    tools/gui.py:606-637).

    ``tables``: optional :class:`TrackingTables`: with UI ``tracked`` on,
    sequence playback drives the TRACKING-REFINED per-frame rows instead
    of the raw dataset params (the reference's train-mode playback,
    tools/gui.py:606-637 reading the optimized embeddings).

    The frame is captured here, as a CUDA graph, in the caller's
    thread (on the CPU the graph runs its function); each call copies the
    state into the graph's inputs, replays it under a lock (the server
    answers requests in threads) and returns ``(image, device_ms)``: a
    copy of the float [H, W, 3] frame on the avatar's device (the server
    encodes it there) and the replay's time (CUDA events; the host clock on
    the CPU).

    A frame that drops instances at the binning's static caps (its
    ``overflow``) grows them to that state's occupancy (autosize's probe;
    no cap shrinks), captures the graph anew in the thread it runs in and
    renders again; the JAX package's viewer shows the frame with the
    instances dropped. The callback's ``graph`` attribute is the
    :class:`Graph`, its ``eager(state)`` the same frame computed eagerly,
    its ``overflow`` the instances the last frame (either way) dropped, its
    ``growths`` the overflow that made the caps grow, once a growth, and
    its ``render_cfg`` the caps in use."""
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render.autosize import autosize_render_config
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.utils.graphs import Graph

    render_cfg = render_cfg or RenderConfig()
    n_exp = model.flame.n_exp
    h, w = model.cfg.img_height, model.cfg.img_width
    dev = params.offset.device

    # the graph's static inputs and output
    expr_d = torch.zeros((n_exp,), device=dev)
    pose_d = torch.zeros((15,), device=dev)
    cam_t_d = torch.zeros((3,), device=dev)
    fov_d = torch.zeros((), device=dev)
    bg_d = torch.zeros((3,), device=dev)
    frame_d = torch.zeros((h, w, 3), device=dev)
    overflow_d = torch.zeros((), dtype=torch.int32, device=dev)
    eye = torch.eye(3, device=dev)

    def camera():
        return make_camera(eye, cam_t_d, fov_d, fov_d, w, h, device=dev)

    @torch.no_grad()
    def frame():
        out = fateavatar_forward(model, params, state, expr_d, pose_d, camera(),
                                 bg_color=bg_d, render_cfg=render_fn.render_cfg)
        frame_d.copy_(out["rgb_image"])
        overflow_d.copy_(out["overflow"])

    def grow_caps() -> bool:
        """Grow the binning caps to the current inputs' occupancy and
        capture the frame anew; False when none would grow."""
        cfg = render_fn.render_cfg
        n, R = int(state.alive.shape[0]), cfg.max_tiles_per_gaussian
        view = SimpleNamespace(expression=expr_d, flame_pose=pose_d, camera=camera())
        probe = autosize_render_config(model, params, state, [view], cfg, probe_views=1)
        # a cap of 0 stands for binning's default
        now = {"instance_budget": cfg.instance_budget
               or min((6 if cfg.kernel == "tiles" else 4) * n, n * R),
               "max_tiles_per_gaussian": R,
               "tail_k": min(cfg.tail_k or max(256, n // 16), n)}
        grown = {k: max(v, getattr(probe, k)) for k, v in now.items()}
        if grown == now:
            return False
        render_fn.render_cfg = dataclasses.replace(cfg, **grown)
        render_fn.growths.append(int(overflow_d))
        if dev.type == "cuda":
            graph.capture()
        return True

    _BG = {"white": np.ones(3, np.float32),
           "black": np.zeros(3, np.float32),
           "gray": np.full(3, 0.5, np.float32)}

    def flat(x, n):
        return (np.zeros(n, np.float32) if x is None
                else x.detach().cpu().numpy().astype(np.float32).reshape(-1))

    _cano_exp = flat(model.flame.canonical_exp, n_exp)
    _cano_pose = flat(model.flame.canonical_pose, 15)
    if tables is not None:
        _t_expr = tables.expression.detach().cpu().numpy()
        _t_pose = tables.flame_pose.detach().cpu().numpy()

    def inputs(ui):
        """The UI state as (expr, pose, cam_t, fov, bg), numpy float32."""
        playing = ui.get("playing") and dataset is not None and len(dataset)
        if playing:
            idx = ui.get("frame", 0) % len(dataset)
            if ui.get("tracked") and tables is not None:
                expr = _t_expr[idx, :n_exp].astype(np.float32)
                pose = _t_pose[idx].astype(np.float32).copy()
            else:
                s = dataset.sample(idx)
                expr = np.asarray(s["expression"], np.float32)
                pose = np.asarray(s["flame_pose"], np.float32).copy()
        elif ui.get("canonical"):
            # canonical-pose view (the reference viewer's manual-mode
            # default, tools/gui.py:186-190); orbit still applies below
            expr = _cano_exp[:n_exp].copy()
            pose = _cano_pose[:15].copy()
        else:
            expr = np.zeros(n_exp, np.float32)
            vals = ui.get("exp", [])
            expr[: len(vals)] = np.asarray(vals, np.float32)[:n_exp]
            pose = np.zeros(15, np.float32)
            pose[6] = ui.get("jaw", 0.0)
            neck = ui.get("neck")
            if neck:
                pose[3:6] = np.asarray(neck, np.float32)[:3]
        # orbit as head rotation
        pose[0] = -float(ui.get("pitch", 0.0))
        pose[1] = float(ui.get("yaw", 0.0))
        cam_t = np.array([0.0, 0.0, camera_distance * float(ui.get("zoom", 1.0))],
                         np.float32)
        bg = _BG.get(str(ui.get("bg", "white")), _BG["white"])
        return expr, pose, cam_t, np.float32(ui.get("fov", 0.8)), bg

    lock = threading.Lock()
    buffers = (expr_d, pose_d, cam_t_d, fov_d, bg_d)

    def set_inputs(ui):
        for d, v in zip(buffers, inputs(ui)):
            d.copy_(torch.as_tensor(v))

    def replay() -> float:
        """One call of the graph: its ms (CUDA events; the host clock on
        the CPU)."""
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        graph()
        return (time.perf_counter() - t0) * 1e3

    def render_fn(ui):
        with lock:
            set_inputs(ui)
            device_ms = replay()
            if int(overflow_d) and grow_caps():
                device_ms = replay()
            render_fn.overflow = int(overflow_d)
            return frame_d.clone(), device_ms

    def eager(ui):
        """The same frame computed eagerly, outside the graph."""
        with lock:
            set_inputs(ui)
            frame()
            if int(overflow_d) and grow_caps():
                frame()
            render_fn.overflow = int(overflow_d)
            return frame_d.clone()

    graph = Graph(frame, [frame_d, overflow_d], "the viewer's frame")
    render_fn.graph = graph
    render_fn.eager = eager
    render_fn.render_cfg = render_cfg
    render_fn.growths = []
    render_fn({})      # warm-up and capture here, in the caller's thread
    return render_fn
