"""The tools against the JAX package, on the CPU: PLY export / import,
``save_obj``, the tracing helpers, the web viewer's render callback in
every UI mode, one HTTP round trip (a JPEG, Pillow's bytes), a POST to the
JAX package's viewer and to the port's on one stub callback (equal
headers and body), the GIF fallback of ``write_video`` against the JAX
package's, and ``cli/avatar_gui.build_viewer``.

The viewer's avatar is ``tests/test_viewer.py``'s (a 96-vertex synthetic
FLAME on a sphere template, 32x32), perturbed, carried across by
``convert``; JAX renders through its XLA blend (the package's own viewer
tests do), the port through its plain blend (on the CPU the frame's
``Graph`` runs its function). Images within 2e-4 per pixel: the blends take
the transmittance product in another order (``tests/test_torch_model.py``).
"""

import dataclasses
import io
import json
import os
import pickle
import shutil
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import np_dict, perturb
from torch_layouts import orbit, write_imavatar
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.render import ply as jply
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.render.splats import Gaussians as JGaussians
from fateavatar_tpu.train.datasets import SyntheticDataset as JSyntheticDataset
from fateavatar_tpu.train.tracking import TrackingTables as JTrackingTables
from fateavatar_tpu.utils import obj_io as jobj
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh
from fateavatar_tpu.viewer.web import make_avatar_render_fn as jmake_render_fn

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import avatar_gui, common
from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render import ply as tply
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.render.splats import make_gaussians
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager, save_pytree
from fateavatar_tpu_torch.train.datasets import SyntheticDataset
from fateavatar_tpu_torch.train.loader import checkpoint_tree
from fateavatar_tpu_torch.train.tracking import TrackingTables
from fateavatar_tpu_torch.utils import obj_io as tobj
from fateavatar_tpu_torch.utils import profiling
from fateavatar_tpu_torch.utils.config import load_config
from fateavatar_tpu_torch.utils.jpeg import encode_jpeg
from fateavatar_tpu_torch.utils.png import write_png
from fateavatar_tpu_torch.viewer.web import (
    ViewerServer, make_avatar_render_fn, quantize,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, NV, N_EXP, DIST = 32, 96, 4, 0.4
ATOL = 2e-4


# ---------------------------------------------------------------------------
# PLY, OBJ, profiling
# ---------------------------------------------------------------------------

def _splats(seed=0, n=40, sh_degree=1):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    f = {"xyz": rng.normal(size=(n, 3)), "scaling": rng.normal(size=(n, 3)) - 3,
         "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(size=(n, 1)),
         "features_dc": rng.normal(size=(n, 1, 3)), "features_rest": rng.normal(size=(n, k, 3))}
    f = {key: v.astype(np.float32) for key, v in f.items()}
    alive = rng.random(n) < 0.7
    return f, alive, sh_degree


def test_ply_byte_equal_and_read_across(tmp_path):
    """The port's ``save_ply`` writes JAX's bytes for the same splats (alive
    ones only, ``f_rest`` channel-major, little-endian); each package's
    ``load_ply`` reads the other's file back to the same padded splats."""
    f, alive, deg = _splats()
    tg = make_gaussians(f["xyz"], f["scaling"], f["rotation"], f["opacity"],
                        f["features_dc"], f["features_rest"], alive, sh_degree=deg,
                        device="cpu")
    jg = JGaussians(**{k: jnp.asarray(v) for k, v in f.items()},
                    alive=jnp.asarray(alive), sh_degree=deg)
    pt, pj = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert tply.save_ply(pt, tg) == jply.save_ply(pj, jg) == int(alive.sum())
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    cap = 64
    back_t = tply.load_ply(pj, capacity=cap, device="cpu")
    back_j = jply.load_ply(pt, capacity=cap)
    assert back_t.sh_degree == back_j.sh_degree == deg
    for k in ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest", "alive"):
        np.testing.assert_array_equal(getattr(back_t, k).numpy(), np.asarray(getattr(back_j, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(back_t, k).numpy()[:int(alive.sum())],
                                      f[k][alive] if k != "alive" else alive[alive], err_msg=k)
    # posed positions override xyz
    xyz = f["xyz"] + 1.0
    tply.save_ply(pt, tg, xyz=torch.from_numpy(xyz))
    np.testing.assert_array_equal(tply.load_ply(pt, device="cpu").xyz.numpy(), xyz[alive])


def test_save_obj_round_trip(tmp_path):
    """``save_obj`` writes JAX's text; ``load_obj`` reads it back."""
    mesh = sphere_obj_mesh(64)
    pt, pj = str(tmp_path / "port.obj"), str(tmp_path / "jax.obj")
    tobj.save_obj(pt, mesh.verts, mesh.faces)
    jobj.save_obj(pj, mesh.verts, mesh.faces)
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    back = tobj.load_obj(pt)
    np.testing.assert_allclose(back.verts, mesh.verts, atol=5e-7)
    np.testing.assert_array_equal(back.faces, mesh.faces)


def test_profiling_helpers(tmp_path):
    """``span`` keeps a record (name, parent, ids) only while tracing is on,
    ``counters`` gives deltas, and ``trace`` writes a Chrome trace that
    holds an ``fa.`` span."""
    profiling.reset()
    x = torch.ones(64, 64)
    with profiling.span("off"):
        x @ x
    assert profiling.spans() == []
    before = profiling.counters()
    profiling.count("tools.frames", 3)
    profiling.count("tools.seconds", 0.25)
    assert profiling.counters(before) == {**{k: 0 for k in before},
                                          "tools.frames": 3, "tools.seconds": 0.25}
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("viewer.frame", call=1):
            (x @ x).sum()
    assert not profiling.is_tracing()
    (rec,) = profiling.spans()
    assert (rec.name, rec.parent, rec.ids) == ("viewer.frame", None, {"call": 1})
    assert rec.end >= rec.start
    with open(tmp_path / "tr" / "trace.json") as fh:
        assert "fa.viewer.frame" in fh.read()
    profiling.reset()


# ---------------------------------------------------------------------------
# the viewer
# ---------------------------------------------------------------------------

UI_STATES = {
    "default": {},
    "sliders": {"exp": [0.8, -0.5, 0.3], "jaw": 0.2, "neck": [0.1, -0.2, 0.05]},
    "orbit-zoom-fov": {"yaw": 0.5, "pitch": -0.3, "zoom": 1.3, "fov": 0.6},
    "bg-black": {"bg": "black", "yaw": -0.4},
    "bg-gray": {"bg": "gray", "exp": [0.5]},
    "canonical": {"canonical": True, "exp": [2.0], "jaw": 0.5, "yaw": 0.2},
    "play-raw": {"playing": True, "frame": 1, "tracked": False},
    "play-tracked": {"playing": True, "frame": 4, "tracked": True, "pitch": 0.1},
}


@pytest.fixture(scope="module")
def avatar():
    """One perturbed avatar (canonical exp / pose off zero) in both
    packages, a 3-frame SyntheticDataset in each (the same numpy draws) and
    tracking tables off the raw rows: ``(jax, port)``, each (model, params,
    state, dataset, tables)."""
    flame = synthetic_flame(n_verts=NV, n_shape=6, n_exp=N_EXP, seed=0)
    flame = flame.replace(canonical_exp=jnp.full((1, N_EXP), 0.7),
                          canonical_pose=jnp.zeros((1, 15)).at[0, 6].set(0.3))
    cfg = jfa.FateAvatarConfig(tex_size=8, capacity=128, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    model, params, state = jfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg)
    params = params.replace(**perturb(np_dict(params), seed=3))
    rows = np.random.default_rng(7).normal(size=(3, N_EXP)).astype(np.float32)
    poses = np.random.default_rng(8).normal(size=(3, 15)).astype(np.float32) * 0.05
    jds = JSyntheticDataset(num_frames=3, img_res=(RES, RES), n_exp=N_EXP)
    jtab = JTrackingTables(expression=jnp.asarray(rows), flame_pose=jnp.asarray(poses),
                           cam_t=jnp.zeros((3, 3)))
    m = convert.fateavatar_model(np_dict(model), device="cpu")
    p = convert.fateavatar_params(np_dict(params), device="cpu")
    s = convert.fateavatar_state(np_dict(state), device="cpu")
    ds = SyntheticDataset(num_frames=3, img_res=(RES, RES), n_exp=N_EXP)
    tab = TrackingTables(expression=torch.from_numpy(rows), flame_pose=torch.from_numpy(poses),
                         cam_t=torch.zeros(3, 3))
    return (model, params, state, jds, jtab), (m, p, s, ds, tab)


@pytest.fixture(scope="module")
def viewers(avatar):
    """Both packages' render callbacks on the avatar."""
    (model, params, state, jds, jtab), (m, p, s, ds, tab) = avatar
    jfn = jmake_render_fn(model, params, state, dataset=jds, camera_distance=DIST,
                          render_cfg=JRenderConfig(impl="xla", max_per_tile=64, chunk=32),
                          tables=jtab)
    fn = make_avatar_render_fn(m, p, s, dataset=ds, camera_distance=DIST,
                               render_cfg=RenderConfig(max_per_tile=64, chunk=32), tables=tab)
    return jfn, fn


@pytest.mark.parametrize("mode", list(UI_STATES))
def test_render_fn_matches_jax(viewers, mode):
    """Each UI mode (sliders, orbit, zoom, fov, background, canonical view,
    raw and tracked playback) renders JAX's frame within 2e-4, dropping no
    instance; the frame is the eager forward of the same state (on the CPU
    the graph runs it)."""
    jfn, fn = viewers
    ui = UI_STATES[mode]
    ref, jms = jfn(ui)
    img, ms = fn(ui)
    assert img.shape == (RES, RES, 3) and ms > 0 and fn.overflow == 0
    np.testing.assert_allclose(img, np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(fn.eager(ui), img)
    if mode.startswith("bg"):
        assert np.allclose(img[0, 0], {"bg-black": 0.0, "bg-gray": 0.5}[mode], atol=1e-3)


def test_viewer_grows_caps_on_overflow(avatar, viewers):
    """Caps far too small (one tile a splat, a budget of 16 instances):
    the build's frame overflows, the caps grow to its occupancy and it
    renders again; every frame after drops no instance and equals the
    frame at ample caps."""
    m, p, s, ds, tab = avatar[1]
    _, ample = viewers
    small = make_avatar_render_fn(
        m, p, s, dataset=ds, camera_distance=DIST, tables=tab,
        render_cfg=RenderConfig(max_per_tile=64, chunk=32, max_tiles_per_gaussian=1,
                                instance_budget=16))
    assert small.growths and min(small.growths) > 0 and small.overflow == 0
    cfg = small.render_cfg
    assert cfg.max_tiles_per_gaussian > 1 and cfg.instance_budget > 16
    for ui in UI_STATES.values():
        img, _ = small(ui)
        assert small.overflow == 0
        np.testing.assert_array_equal(img, ample(ui)[0])
        np.testing.assert_array_equal(small.eager(ui), img)


def test_render_modes_differ(viewers):
    """The modes reach the frame: tracked rows, canonical and background
    each change it."""
    _, fn = viewers
    before = fn.graph.replays
    frames = {m: fn(ui)[0] for m, ui in UI_STATES.items()}
    assert fn.graph.replays == before + len(UI_STATES)     # one replay a frame
    for a, b in (("play-raw", "play-tracked"), ("default", "canonical"),
                 ("default", "bg-black"), ("default", "sliders")):
        assert np.abs(frames[a] - frames[b]).max() > 1e-3, (a, b)


def _post(port, state):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                 data=json.dumps(state).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers, r.read()


def test_http_round_trip_png(viewers, tmp_path):
    """One POST on port 0: the frame as the JAX package's viewer sends it,
    a JPEG at quality 90 (``image/jpeg``; it was a PNG before the port had
    an encoder): Pillow's bytes of the callback's frame quantized as the
    server does, the device ms header, and the page with the controls."""
    from PIL import Image

    _, fn = viewers
    srv = ViewerServer(fn, RES, RES, N_EXP, port=0)
    srv.serve_background()
    try:
        ui = UI_STATES["sliders"]
        headers, body = _post(srv.port, ui)
        assert headers["Content-Type"] == "image/jpeg"
        assert float(headers["X-Device-Ms"]) > 0
        frame = quantize(fn.eager(ui)).numpy()
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=90)
        assert body == buf.getvalue() == encode_jpeg(frame, 90)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=60) as r:
            page = r.read().decode()
        assert "play sequence" in page and "tracked params" in page and "X-Device-Ms" in page
    finally:
        srv.shutdown()


def test_viewer_post_matches_jax():
    """The JAX package's ViewerServer and the port's, each on one stub
    callback returning ``(image, 1.25)``: equal ``Content-Type``,
    ``X-Device-Ms`` and body (the port's own JPEG encoder against PIL)."""
    from fateavatar_tpu.viewer.web import ViewerServer as JViewerServer

    rng = np.random.default_rng(11)
    image = rng.random((40, 56, 3)).astype(np.float32) * 1.1 - 0.05
    stub = lambda state: (image, 1.25)   # noqa: E731
    jsrv = JViewerServer(stub, 56, 40, N_EXP, port=0)
    srv = ViewerServer(stub, 56, 40, N_EXP, port=0)
    jsrv.serve_background()
    srv.serve_background()
    try:
        jh, jbody = _post(jsrv.httpd.server_address[1], UI_STATES["sliders"])
        h, body = _post(srv.port, UI_STATES["sliders"])
    finally:
        jsrv.shutdown()
        jsrv.httpd.server_close()
        srv.shutdown()
    assert h["Content-Type"] == jh["Content-Type"] == "image/jpeg"
    assert h["X-Device-Ms"] == jh["X-Device-Ms"] == "1.250"
    assert body == jbody


def _moving_head(n=6, h=72, w=96, seed=0):
    """Frames like the eval videos': a white background and a shaded,
    lightly noisy disc that moves and changes its shading."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    out = []
    for i in range(n):
        img = np.ones((h, w, 3))
        head = (xx - 0.45 - 0.03 * i) ** 2 + (yy - 0.4) ** 2 < 0.08
        shade = np.stack([0.8 * np.sin(xx * 9 + 0.3 * i) ** 2, 0.6 + 0.2 * yy, 0.5 * xx], -1)
        img[head] = shade[head] + rng.normal(0, 0.02, (int(head.sum()), 3))
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out


def test_gif_fallback_against_jax(tmp_path, monkeypatch):
    """write_video with no ffmpeg in both packages on the same 6 frames: the
    JAX package's GIF is PIL's (median cut, delta frames, LZW), the port's
    its own. Decoded by PIL, each of the port's frames errs at most 1.1x
    the JAX GIF's mean absolute error plus 0.5 levels, and the file is at
    most 1.25x the JAX GIF's size."""
    from PIL import Image

    from fateavatar_tpu.utils import logging as jlogging
    from fateavatar_tpu_torch.utils import logging as tlogging

    frames = _moving_head()
    # both writers look the binary up through shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert jlogging.write_video(str(tmp_path / "j.mp4"), frames, fps=25)
    assert tlogging.write_video(str(tmp_path / "t.mp4"), frames, fps=25)
    mae = {}
    for k in ("j", "t"):
        gif = Image.open(tmp_path / f"{k}.gif")
        assert gif.n_frames == len(frames) and gif.size == (96, 72)
        mae[k] = []
        for i, fr in enumerate(frames):
            gif.seek(i)
            mae[k].append(np.abs(np.asarray(gif.convert("RGB")).astype(int) - fr).mean())
    assert all(t <= 1.1 * j + 0.5 for t, j in zip(mae["t"], mae["j"])), mae
    sizes = {k: (tmp_path / f"{k}.gif").stat().st_size for k in ("j", "t")}
    assert sizes["t"] <= 1.25 * sizes["j"], sizes


# ---------------------------------------------------------------------------
# cli/avatar_gui
# ---------------------------------------------------------------------------

def _gui_workspace(ws):
    """FLAME pickle, template OBJ, a 32x32 IMAvatar layout (4 train, 2 test
    frames) and the overrides that build the avatar from them."""
    data, _ = synthetic_flame_data(n_verts=NV, n_exp=50, seed=0)
    with open(os.path.join(ws, "flame.pkl"), "wb") as fh:
        pickle.dump(data, fh)
    mesh = sphere_obj_mesh(NV)
    with open(os.path.join(ws, "head.obj"), "w") as fh:
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.verts)
        fh.writelines(f"vt {uv[0]:.6f} {uv[1]:.6f}\n" for uv in mesh.uvcoords)
        fh.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in f) + "\n"
                      for f in mesh.faces)
    rng = np.random.default_rng(0)
    root = os.path.join(ws, "imavatar", "subj")
    for mode, n in (("train", 4), ("test", 2)):
        imgs = [(rng.random((RES, RES, 4)) * 255).astype(np.uint8) for _ in range(n)]
        write_imavatar(root, mode, imgs, orbit(n), rng.normal(size=(n, 50)) * 0.05,
                       rng.normal(size=(n, 15)) * 0.05, rng.normal(size=100) * 0.1, 0.8,
                       write_png)
    return ["--config", os.path.join(REPO, "configs", "fateavatar.yaml"), "--device", "cpu",
            "--port", "0", "--camera_distance", str(DIST),
            f"dataset.root_path={root}", f"assets.flame_model_path={ws}/flame.pkl",
            f"assets.template_mesh_path={ws}/head.obj", f"dataset.img_res=[{RES},{RES}]",
            "model.tex_size=8", "training.max_points_num=128",
            "render.max_tiles_per_gaussian=16"]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in (("features_dc", 0.8), ("opacity", 1.5), ("offset", 1.0)):
        v = getattr(params, k)
        out[k] = v + torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)) * s
    return dataclasses.replace(params, **out)


def test_avatar_gui_build_viewer(tmp_path):
    """``build_viewer`` on a workspace with only a training checkpoint
    (with tracking tables): variant "latest", tracked playback from the
    tables; then with ``checkpoints_baked/baked.npz`` beside it: variant
    "baked", frames from the baked params. Each served frame equals the
    eager forward of the loaded avatar."""
    ws = str(tmp_path)
    args = _gui_workspace(ws)
    run = os.path.join(ws, "run")
    cfg = load_config(args[1], args[args.index("--camera_distance") + 2:])
    train_ds, _ = common.construct_datasets(cfg)
    flame = common.construct_flame(cfg, train_ds, device="cpu")
    model, params, state = common.construct_model(cfg, flame, device="cpu")
    trained = _perturbed(params, 1)
    tables = {"expression": torch.full((4, 50), 0.5), "flame_pose": torch.zeros(4, 15),
              "cam_t": torch.zeros(4, 3)}
    CheckpointManager(os.path.join(run, "checkpoints")).save(
        1, checkpoint_tree(trained, state, epoch=1) | {"train_tables": tables})
    args = [*args, "--workspace", run]

    def frame(p, ui_expr, ui_pose, zoom=1.0):
        cam = make_camera(np.eye(3), [0.0, 0.0, DIST * zoom], 0.8, 0.8, RES, RES, device="cpu")
        with torch.no_grad():
            return fateavatar_forward(model, p, state, torch.as_tensor(ui_expr),
                                      torch.as_tensor(ui_pose), cam,
                                      bg_color=torch.ones(3),
                                      render_cfg=common.render_config(cfg))["rgb_image"].numpy()

    srv = avatar_gui.build_viewer(args)
    try:
        assert srv.variant == "latest"
        img, _ = srv.render_fn({"playing": True, "frame": 2, "tracked": True})
        pose = np.zeros(15, np.float32)
        np.testing.assert_array_equal(img, frame(trained, np.full(50, 0.5, np.float32), pose))
    finally:
        srv.httpd.server_close()

    baked = _perturbed(params, 2)
    os.makedirs(os.path.join(run, "checkpoints_baked"))
    save_pytree(os.path.join(run, "checkpoints_baked", "baked.npz"),
                {"params": baked, "state": state})
    srv = avatar_gui.build_viewer(args)
    try:
        assert srv.variant == "baked"
        img, _ = srv.render_fn({"exp": [0.3], "zoom": 1.2})
        expr = np.zeros(50, np.float32)
        expr[0] = 0.3
        np.testing.assert_array_equal(img, frame(baked, expr, np.zeros(15, np.float32), 1.2))
        assert np.abs(img - frame(trained, expr, np.zeros(15, np.float32), 1.2)).max() > 1e-3
    finally:
        srv.httpd.server_close()
