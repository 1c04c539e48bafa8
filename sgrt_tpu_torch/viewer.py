"""Interactive local viewer (PyTorch port of sgrt_tpu.viewer): the
equivalent of the reference's Vulkan/ImGui viewer (src/vk-renderer/,
renderer_t; controls at src/volumetric-ray-tracer/main.cpp:228-242).

A small local HTTP server renders frames on demand on the scene's device
and streams PNGs to a browser page with the reference's interactive
controls: orbit angle, camera offset, focal length, tiling on/off, erf/exp
mode, global sigma/magnitude multipliers, per-axis scales (anisotropic
Gaussians), and per-Gaussian edits, the analog of the ImGui sliders that
mutate single `staging_gaussians` entries live (main.cpp:234-241). Edits go
to a staging scene guarded by a lock and are picked up at the next frame,
as the reference's staging-buffer mutex (vk-renderer.cpp:157,
main.cpp:261-262). Frame time is shown like the reference's ImGui stats.

Endpoints:
    GET /                   the control page
    GET /render?...         one frame as PNG (X-Render-Ms, X-Overflow headers)
    GET /scene              staged Gaussian parameters as JSON
    GET /edit?index=i&...   mutate one staged Gaussian (mu=x,y,z sigma=s
                            magnitude=m albedo=r,g,b); index=-1 resets all
                            to the originally loaded scene

Usage:  python -m sgrt_tpu_torch.viewer [-f scene.obj | -g DIM] [--port 8765]
            [--device cuda|cpu] [--backend kernel|torch]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from sgrt_tpu_torch.models.gaussians import GaussianScene

# the server's capacity probe: sample orbit angles at the default camera,
# and the margin over the largest count (edits and sliders grow tiles)
PROBE_ANGLES = (0.0, 45.0, 90.0, 135.0, 180.0)
PROBE_MARGIN = 1.5
FIELDS = ("mu", "sigma", "magnitude", "albedo")

_PAGE = """<!DOCTYPE html>
<html><head><title>sgrt_tpu_torch viewer</title><style>
body { font-family: monospace; background: #111; color: #ddd; margin: 2em; }
.row { margin: 0.4em 0; }
label { display: inline-block; width: 14em; }
img { image-rendering: pixelated; border: 1px solid #444; margin-top: 1em; }
#stats { color: #8f8; }
fieldset { border: 1px solid #444; margin-top: 1em; }
</style></head><body>
<h2>sgrt_tpu_torch — volumetric Gaussian ray tracer</h2>
<div class="row"><label>orbit angle</label>
  <input type="range" id="angle" min="0" max="360" step="1" value="30"></div>
<div class="row"><label>camera offset</label>
  <input type="range" id="offset" min="-10" max="-1" step="0.1" value="-4"></div>
<div class="row"><label>focal length</label>
  <input type="range" id="focal" min="0.2" max="3" step="0.05" value="1"></div>
<div class="row"><label>sigma scale</label>
  <input type="range" id="sigma" min="0.2" max="3" step="0.05" value="1"></div>
<div class="row"><label>magnitude scale</label>
  <input type="range" id="mag" min="0.1" max="4" step="0.05" value="1"></div>
<div class="row"><label>aniso scale x/y/z</label>
  <input type="range" id="sx" min="0.2" max="3" step="0.05" value="1">
  <input type="range" id="sy" min="0.2" max="3" step="0.05" value="1">
  <input type="range" id="sz" min="0.2" max="3" step="0.05" value="1"></div>
<div class="row"><label>tiled (modes 5-8)</label>
  <input type="checkbox" id="tiled" checked></div>
<div class="row"><label>erf</label>
  <select id="erf"><option>as5</option><option>as3</option>
  <option>taylor</option><option>spline</option><option>spline_mirror</option></select></div>
<div class="row"><label>exp</label>
  <select id="exp"><option>exact</option><option>fast</option>
  <option>spline</option></select></div>
<fieldset><legend>per-Gaussian edit (main.cpp:234-241 analog)</legend>
<div class="row"><label>gaussian index</label>
  <input type="number" id="gidx" min="0" value="0" style="width:6em">
  <button id="load">load</button> <button id="reset">reset scene</button></div>
<div class="row"><label>mu x/y/z</label>
  <input type="range" class="ged" id="gmx" min="-3" max="3" step="0.02">
  <input type="range" class="ged" id="gmy" min="-3" max="3" step="0.02">
  <input type="range" class="ged" id="gmz" min="-3" max="3" step="0.02"></div>
<div class="row"><label>sigma</label>
  <input type="range" class="ged" id="gs" min="0.01" max="1" step="0.01"></div>
<div class="row"><label>magnitude</label>
  <input type="range" class="ged" id="gm" min="0" max="5" step="0.05"></div>
<div class="row"><label>albedo r/g/b</label>
  <input type="range" class="ged" id="gar" min="0" max="1" step="0.02">
  <input type="range" class="ged" id="gag" min="0" max="1" step="0.02">
  <input type="range" class="ged" id="gab" min="0" max="1" step="0.02"></div>
</fieldset>
<div class="row" id="stats">-</div>
<img id="view" width="512" height="512">
<script>
const ids = ['angle','offset','focal','sigma','mag','sx','sy','sz',
             'tiled','erf','exp'];
let busy = false, dirty = false;
async function refresh() {
  if (busy) { dirty = true; return; }
  busy = true;
  const p = new URLSearchParams();
  for (const id of ids) {
    const el = document.getElementById(id);
    p.set(id, el.type === 'checkbox' ? (el.checked ? 1 : 0) : el.value);
  }
  const t0 = performance.now();
  const resp = await fetch('/render?' + p.toString());
  const ms = resp.headers.get('X-Render-Ms');
  const ovf = parseInt(resp.headers.get('X-Overflow') || '0');
  const blob = await resp.blob();
  document.getElementById('view').src = URL.createObjectURL(blob);
  const stats = document.getElementById('stats');
  stats.textContent =
    `device render: ${ms} ms   round-trip: ${(performance.now()-t0).toFixed(1)} ms` +
    (ovf ? `   OVERFLOW: ${ovf} tile(s) over capacity — frame inexact` : '');
  stats.style.color = ovf ? '#f55' : '#8f8';
  busy = false;
  if (dirty) { dirty = false; refresh(); }
}
for (const id of ids)
  document.getElementById(id).addEventListener('input', refresh);
async function loadG() {
  const i = document.getElementById('gidx').value;
  const s = await (await fetch('/scene')).json();
  const g = s.gaussians[i];
  if (!g) return;
  const set = (id, v) => document.getElementById(id).value = v;
  set('gmx', g.mu[0]); set('gmy', g.mu[1]); set('gmz', g.mu[2]);
  set('gs', g.sigma); set('gm', g.magnitude);
  set('gar', g.albedo[0]); set('gag', g.albedo[1]); set('gab', g.albedo[2]);
}
async function editG() {
  const v = id => document.getElementById(id).value;
  const p = new URLSearchParams();
  p.set('index', v('gidx'));
  p.set('mu', [v('gmx'), v('gmy'), v('gmz')].join(','));
  p.set('sigma', v('gs')); p.set('magnitude', v('gm'));
  p.set('albedo', [v('gar'), v('gag'), v('gab')].join(','));
  await fetch('/edit?' + p.toString());
  refresh();
}
for (const el of document.querySelectorAll('.ged'))
  el.addEventListener('input', editG);
document.getElementById('load').addEventListener('click', loadG);
document.getElementById('reset').addEventListener('click', async () => {
  await fetch('/edit?index=-1'); refresh();
});
refresh(); loadG();
</script></body></html>"""


class SceneStage:
    """Mutable staged scene and its lock: the reference's staging_gaussians
    picked up at frame start (main.cpp:261-262) with its staging mutex
    (vk-renderer.cpp:157). The staged fields live on the host."""

    def __init__(self, scene: GaussianScene):
        self._orig = scene
        self._lock = threading.Lock()
        self._np = self._host_copy()

    def _host_copy(self) -> dict:
        return {f: getattr(self._orig, f).detach().cpu().numpy().copy() for f in FIELDS}

    def snapshot(self) -> GaussianScene:
        """The staged scene as a GaussianScene on the loaded scene's device
        (called at frame start)."""
        dev = self._orig.device
        with self._lock:
            return GaussianScene(*(torch.tensor(self._np[f], device=dev) for f in FIELDS))

    def as_json(self) -> dict:
        with self._lock:
            return {
                "n": int(self._np["sigma"].shape[0]),
                "gaussians": [
                    {
                        "mu": [float(x) for x in self._np["mu"][i]],
                        "sigma": float(self._np["sigma"][i]),
                        "magnitude": float(self._np["magnitude"][i]),
                        "albedo": [float(x) for x in self._np["albedo"][i]],
                    }
                    for i in range(self._np["sigma"].shape[0])
                ],
            }

    def edit(self, index: int, mu=None, sigma=None, magnitude=None, albedo=None) -> bool:
        """Mutate one staged Gaussian; index=-1 resets to the loaded scene."""
        with self._lock:
            if index == -1:
                self._np = self._host_copy()
                return True
            if not (0 <= index < self._np["sigma"].shape[0]):
                return False
            for f, v in (("mu", mu), ("sigma", sigma), ("magnitude", magnitude),
                         ("albedo", albedo)):
                if v is not None:
                    self._np[f][index] = v
            return True


def probe_server_capacity(scene: GaussianScene, tiles) -> int:
    """The server's per-tile capacity for a scene: the largest tile count
    over PROBE_ANGLES at the default camera (offset -4, focal length 1),
    times PROBE_MARGIN, at least 32. Waits for the device."""
    from sgrt_tpu_torch.ops.frame import probe_capacity

    return max(32, int(probe_capacity(scene, PROBE_ANGLES, -4.0, 1.0, tiles) * PROBE_MARGIN))


def render_query(scene: GaussianScene, q: dict, width: int, height: int, tiles,
                 capacity: int, backend: str = "kernel"):
    """One /render query's frame → (image (H, W, 3) on the scene's device,
    overflow (0-d int32)). Per-axis scales other than 1 render the scene
    as anisotropic Gaussians: tiled through render_tiled_aniso at a
    capacity probed on their max-scale proxy (iso_proxy), untiled through
    the anisotropic kernels as one tile (or the plain renderer)."""
    from sgrt_tpu_torch.ops.frame import orbit_camera, render_orbit_frame

    scene = scene.replace(sigma=scene.sigma * float(q.get("sigma", 1)),
                          magnitude=scene.magnitude * float(q.get("mag", 1)))
    angle, offset = float(q.get("angle", 30)), float(q.get("offset", -4))
    focal = float(q.get("focal", 1))
    tiled = q.get("tiled", "1") == "1"
    erf_name, exp_name = q.get("erf", "as5"), q.get("exp", "exact")
    sxyz = tuple(float(q.get(k, 1)) for k in ("sx", "sy", "sz"))
    if sxyz == (1.0, 1.0, 1.0):
        return render_orbit_frame(scene, angle, offset, focal, width=width, height=height,
                                  tiles=tiles, capacity=capacity, use_tiling=tiled,
                                  backend=backend, erf_name=erf_name, exp_name=exp_name)

    from sgrt_tpu_torch.ops import anisotropic as an

    ascene = an.from_isotropic(scene)
    ascene = ascene.replace(scale=ascene.scale * torch.tensor([sxyz], device=scene.device))
    cam = orbit_camera(angle, offset, focal, width, height, device=scene.device)
    if tiled:
        # the scaled footprints outgrow the isotropic probe: probe again on
        # the max-scale proxy that culls them
        cap = max(capacity, probe_server_capacity(an.iso_proxy(ascene), tiles))
        return an.render_tiled_aniso(ascene, cam, tiles=tiles, capacity=cap, backend=backend,
                                     erf_name=erf_name, exp_name=exp_name)
    if backend == "kernel":
        from sgrt_tpu_torch.ops.cuda_render import render_rays

        o, dirs = cam.rays()
        img = render_rays(o, dirs, ascene, erf_name=erf_name,
                          exp_name=exp_name).reshape(height, width, 3)
    else:
        img = an.render_aniso(ascene, cam, erf_name=erf_name, exp_name=exp_name)
    return img, torch.zeros((), dtype=torch.int32, device=img.device)


def make_handler(scene: GaussianScene, width, height, tiles, capacity, backend="kernel"):
    from sgrt_tpu_torch.utils.image import encode_png, to_rgba_u8

    stage = SceneStage(scene)

    class Handler(BaseHTTPRequestHandler):
        scene_stage = stage  # exposed for tests
        tile_capacity = capacity

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/scene":
                self._send(200, "application/json", json.dumps(stage.as_json()).encode())
            elif url.path == "/edit":
                try:
                    kw = {}
                    if "mu" in q:
                        kw["mu"] = [float(x) for x in q["mu"].split(",")]
                    if "sigma" in q:
                        kw["sigma"] = float(q["sigma"])
                    if "magnitude" in q:
                        kw["magnitude"] = float(q["magnitude"])
                    if "albedo" in q:
                        kw["albedo"] = [float(x) for x in q["albedo"].split(",")]
                    ok = stage.edit(int(q["index"]), **kw)
                except (KeyError, ValueError):
                    ok = False
                self._send(200 if ok else 400, "application/json",
                           json.dumps({"ok": ok}).encode())
            elif url.path == "/render":
                t0 = time.perf_counter()
                img, overflow = render_query(stage.snapshot(), q, width, height, tiles,
                                             capacity, backend)
                img_np = img.cpu().numpy()  # waits for the device
                ms = (time.perf_counter() - t0) * 1e3
                # overflow (Gaussians dropped from a tile past its capacity)
                # goes to the page: a frame must not render wrong unnoticed
                self._send(200, "image/png", encode_png(to_rgba_u8(img_np)),
                           extra=(("X-Render-Ms", f"{ms:.1f}"),
                                  ("X-Overflow", str(int(overflow)))))
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def make_server(scene: GaussianScene, width=256, height=256, tiles=16, capacity=None,
                host="127.0.0.1", port=0, backend="kernel") -> ThreadingHTTPServer:
    """Construct (but do not start) the viewer's server over a scene on its
    device; port=0 picks a free port (server_address[1] has it). capacity
    None probes it (probe_server_capacity)."""
    from sgrt_tpu_torch.ops.frame import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if capacity is None:
        capacity = probe_server_capacity(scene, tiles)
    handler = make_handler(scene, width, height, tiles, capacity, backend)
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sgrt_tpu_torch interactive viewer")
    ap.add_argument("--file", "-f", default=None)
    ap.add_argument("--grid", "-g", type=int, default=4)
    ap.add_argument("--width", "-w", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--tiles", type=int, default=16)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--backend", choices=("kernel", "torch"), default="kernel",
                    help="Hot-loop backend: the CUDA kernels or plain tensor ops.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Device to render on (cpu runs the kernels' plain versions).")
    args = ap.parse_args(argv)

    from sgrt_tpu_torch.models.gaussians import grid_scene, scene_from_obj

    scene = (scene_from_obj(args.file, device=args.device) if args.file
             else grid_scene(args.grid, device=args.device))
    server = make_server(scene, args.width, args.height, args.tiles, port=args.port,
                         backend=args.backend)
    print(f"sgrt_tpu_torch viewer: http://127.0.0.1:{server.server_address[1]}/  "
          f"({scene.n} Gaussians, {args.backend} on {args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
