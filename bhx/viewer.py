"""Interactive viewer: browser-based equivalent of the reference's app shell.

The reference is a winit event loop + egui settings windows + WASD/mouse
camera controller (src/app.rs, src/ui/*, src/input_manager.rs,
src/scene/mod.rs:38-81).  A GPU renderer in a datacenter has no window, so the
interactive surface is a small HTTP server: the browser sends camera/setting
state, the server renders a frame (jitted; re-rendering reuses the compiled
graph as long as static settings don't change) and returns a PNG.

Controls (mirroring the reference):
  W/A/S/D  move forward/left/back/right     Q/E  move down/up
  drag     yaw/pitch the camera             wheel: fov
  panel    every BlackHole/Renderer setting the egui UI exposes
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>bhx viewer</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; display:flex }
#img { flex:1; image-rendering:auto; max-height:100vh; object-fit:contain }
#panel { width:260px; padding:10px; background:#1a1a1a; overflow-y:auto }
label { display:block; margin-top:8px }
input[type=range] { width:100% }
</style></head><body>
<img id="img" tabindex="0">
<div id="panel">
  <b>bhx viewer</b>
  <div id="status"></div>
  <label>mass <span id="mass_v"></span>
    <input type="range" id="mass" min="0.05" max="2.0" step="0.05" value="0.5"></label>
  <label>spin <span id="spin_v"></span>
    <input type="range" id="spin" min="0" max="0.99" step="0.01" value="0"></label>
  <label>disk inner <input type="range" id="disk_inner" min="1" max="8" step="0.25" value="2"></label>
  <label>disk outer <input type="range" id="disk_outer" min="4" max="18" step="0.5" value="10"></label>
  <label>feather <input type="range" id="feather" min="0" max="1" step="0.05" value="0.3"></label>
  <label>time <input type="range" id="time" min="0" max="20" step="0.1" value="0"></label>
  <label><input type="checkbox" id="show_disk" checked> disk</label>
  <label><input type="checkbox" id="show_texture" checked> disk texture</label>
  <label><input type="checkbox" id="show_redshift" checked> red/blue shift</label>
  <label><input type="checkbox" id="show_sky" checked> sky</label>
  <label><input type="checkbox" id="bloom" checked> bloom</label>
  <label>mix ratio <input type="range" id="mix_ratio" min="0" max="1" step="0.05" value="0.7"></label>
  <label><input type="checkbox" id="fxaa" checked> fxaa</label>
  <label><input type="checkbox" id="tonemap" checked> ACES tonemap</label>
  <label><input type="checkbox" id="ladder"> adaptive ladder</label>
  <label><input type="checkbox" id="kerr"> exact Kerr geodesics</label>
  <label>integrator
    <select id="integrator"><option value="euler" selected>Euler</option>
    <option value="rk45">RK45</option></select></label>
  <label>step size <span id="step_size_v"></span>
    <input type="range" id="step_size" min="0.02" max="0.5" step="0.01" value="0.15"></label>
  <label>max iterations <span id="max_iter_v"></span>
    <input type="range" id="max_iter" min="100" max="4000" step="100" value="800"></label>
  <label><input type="checkbox" id="paused"> pause</label>
  <button id="step_btn">step time +0.1</button>
  <button id="stats_btn">crossing-overflow stats</button>
  <div id="overflow"></div>
  <hr>
  <b>model</b>
  <label><input type="checkbox" id="mesh_enabled"> mesh (cube or OBJ)</label>
  <label>OBJ path (server-side)
    <input type="text" id="obj_path" placeholder="empty = cube" style="width:100%"></label>
  <label><input type="checkbox" id="mesh_visible" checked> visible</label>
  <label>x <span id="mesh_x_v"></span>
    <input type="range" id="mesh_x" min="-40" max="40" step="0.5" value="6"></label>
  <label>y <span id="mesh_y_v"></span>
    <input type="range" id="mesh_y" min="-40" max="40" step="0.5" value="0"></label>
  <label>z <span id="mesh_z_v"></span>
    <input type="range" id="mesh_z" min="-60" max="40" step="0.5" value="-30"></label>
  <div style="margin-top:10px">WASD/QE move, drag look, wheel fov</div>
</div>
<script>
let cam = {pos:[0,0,-19], yaw:0, pitch:0, fov:1.0};
let busy=false, queued=false;
const img = document.getElementById('img');
function forward() {
  const cy=Math.cos(cam.yaw), sy=Math.sin(cam.yaw);
  const cp=Math.cos(cam.pitch), sp=Math.sin(cam.pitch);
  return [sy*cp, -sp, cy*cp];
}
function state() {
  const g = id => document.getElementById(id);
  return {
    pos:cam.pos, forward:forward(), fov:cam.fov,
    mass:+g('mass').value, spin:+g('spin').value,
    disk_inner:+g('disk_inner').value, disk_outer:+g('disk_outer').value,
    feather:+g('feather').value, time:+g('time').value,
    show_disk:g('show_disk').checked, show_texture:g('show_texture').checked,
    show_redshift:g('show_redshift').checked,
    show_sky:g('show_sky').checked, bloom:g('bloom').checked,
    mix_ratio:+g('mix_ratio').value,
    fxaa:g('fxaa').checked, tonemap:g('tonemap').checked,
    ladder:g('ladder').checked, kerr:g('kerr').checked,
    integrator:g('integrator').value, step_size:+g('step_size').value,
    max_iter:+g('max_iter').value,
    mesh_enabled:g('mesh_enabled').checked, obj_path:g('obj_path').value,
    mesh_visible:g('mesh_visible').checked,
    mesh_pos:[+g('mesh_x').value, +g('mesh_y').value, +g('mesh_z').value],
  };
}
async function render() {
  if (document.getElementById('paused').checked) { queued=true; return; }
  if (busy) { queued=true; return; }
  busy=true;
  const t0=performance.now();
  const r = await fetch('/render', {method:'POST', body:JSON.stringify(state())});
  const blob = await r.blob();
  img.src = URL.createObjectURL(blob);
  let st = {};
  try { st = JSON.parse(r.headers.get('X-Bhx-Stats')||'{}'); } catch(e){}
  document.getElementById('status').textContent =
    `${((performance.now()-t0)/1000).toFixed(2)}s/frame` +
    (st.mrays_per_s ? ` | ${st.mrays_per_s} Mrays/s (device)` : '');
  document.getElementById('mass_v').textContent = state().mass;
  document.getElementById('spin_v').textContent = state().spin;
  document.getElementById('step_size_v').textContent = state().step_size;
  document.getElementById('max_iter_v').textContent = state().max_iter;
  busy=false;
  if (queued) { queued=false; render(); }
}
document.querySelectorAll('input,select').forEach(el=>el.addEventListener('input',render));
document.getElementById('paused').addEventListener('change', e=>{
  if(!e.target.checked && queued){ queued=false; render(); }
});
document.getElementById('stats_btn').addEventListener('click', async ()=>{
  const r = await fetch('/stats', {method:'POST', body:JSON.stringify(state())});
  document.getElementById('overflow').textContent = await r.text();
});
document.getElementById('step_btn').addEventListener('click', ()=>{
  // Step-mode: advance scene time one tick while paused.
  const t = document.getElementById('time');
  t.value = (+t.value + 0.1).toFixed(1);
  const was = document.getElementById('paused').checked;
  document.getElementById('paused').checked = false;
  render();
  document.getElementById('paused').checked = was;
});
let drag=null;
img.addEventListener('mousedown', e=>{drag=[e.clientX,e.clientY]});
window.addEventListener('mouseup', ()=>{drag=null});
window.addEventListener('mousemove', e=>{
  if(!drag) return;
  cam.yaw += (e.clientX-drag[0])*0.005;
  cam.pitch += (e.clientY-drag[1])*0.005;
  cam.pitch = Math.max(-1.5, Math.min(1.5, cam.pitch));
  drag=[e.clientX,e.clientY]; render();
});
img.addEventListener('wheel', e=>{
  cam.fov = Math.max(0.2, Math.min(2.5, cam.fov + e.deltaY*0.001)); render();
});
window.addEventListener('keydown', e=>{
  const f=forward(); const right=[f[2],0,-f[0]];
  const step=1.0;
  const add=(v,s)=>{cam.pos=[cam.pos[0]+v[0]*s, cam.pos[1]+v[1]*s, cam.pos[2]+v[2]*s]};
  if(e.key=='w') add(f,step); if(e.key=='s') add(f,-step);
  if(e.key=='a') add(right,-step); if(e.key=='d') add(right,step);
  if(e.key=='q') add([0,1,0],step); if(e.key=='e') add([0,-1,0],step);
  render();
});
render();
</script></body></html>"""


class ViewerServer:
    """Renders frames on demand; owns one jitted pipeline per static config."""

    def __init__(self, width=480, height=270, max_iterations=800,
                 march_mode="auto"):
        from bhx.config import resolve_march_mode

        march_mode = resolve_march_mode(march_mode)
        self.width = width
        self.height = height
        self.max_iterations = max_iterations
        self.march_mode = march_mode
        self._lock = threading.Lock()
        self._mesh_cache: dict = {}
        self.last_stats: dict = {}

    def _get_mesh(self, obj_path: str):
        """Base mesh arrays for the model panel (cached per path).

        Reference per-mesh settings (src/ui/model_settings.rs:14-54):
        position drag + visibility; both are traced scene leaves here, so
        moving/hiding a mesh never recompiles — only loading a new OBJ
        (new array shapes) does.
        """
        key = obj_path or "__cube__"
        if key not in self._mesh_cache:
            from bhx.geometry.obj import make_mesh

            if obj_path:
                self._mesh_cache[key] = make_mesh(obj_path, name="obj")
            else:
                import numpy as _np

                half = 1.5
                v = _np.array(
                    [[x, y, z] for x in (-1, 1) for y in (-1, 1)
                     for z in (-1, 1)], _np.float32) * half
                faces = [
                    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
                ]
                tri = _np.array(faces, _np.int32)
                fn = []
                for t in range(len(faces)):
                    a, b, c = v[tri[t]]
                    nrm = _np.cross(b - a, c - a)
                    fn.append(nrm / _np.linalg.norm(nrm))
                norm = _np.array(fn, _np.float32)
                tn = (_np.arange(len(faces), dtype=_np.int32)[:, None]
                      * _np.ones((1, 3), _np.int32))
                self._mesh_cache[key] = make_mesh(
                    (v, norm, tri, tn), name="cube", scale=1.0, flip_y=False
                )
        return self._mesh_cache[key]

    def _scene_cfg_from_request(self, req: dict):
        """Request JSON -> (Scene, RenderConfig) — the ONE place panel
        settings are decoded, shared by /render and /stats so diagnostics
        always reflect the frame actually being viewed (ADVICE r4)."""
        import jax.numpy as jnp

        from bhx.config import (
            BloomConfig,
            FxaaConfig,
            Integrator,
            LadderConfig,
            RenderConfig,
        )
        from bhx.scene import Scene

        meshes = ()
        if req.get("mesh_enabled"):
            mesh = self._get_mesh(str(req.get("obj_path", "")).strip())
            mesh = dataclasses.replace(
                mesh,
                position=jnp.asarray(
                    req.get("mesh_pos", [6.0, 0.0, -30.0]), jnp.float32
                ),
                visible=jnp.asarray(bool(req.get("mesh_visible", True))),
            )
            meshes = (mesh,)
        scene = Scene.default(meshes=meshes)
        bh = dataclasses.replace(
            scene.black_hole,
            mass=jnp.float32(req.get("mass", 0.5)),
            spin=jnp.float32(req.get("spin", 0.0)),
            disk_inner=jnp.float32(req.get("disk_inner", 2.0)),
            disk_outer=jnp.float32(req.get("disk_outer", 10.0)),
            feather=jnp.float32(req.get("feather", 0.3)),
        )
        cam = dataclasses.replace(
            scene.camera,
            position=jnp.asarray(req.get("pos", [0, 0, -19]), jnp.float32),
            forward=jnp.asarray(req.get("forward", [0, 0, 1]), jnp.float32),
            fov=jnp.float32(req.get("fov", 1.0)),
        )
        scene = dataclasses.replace(
            scene, camera=cam, black_hole=bh,
            time=jnp.float32(req.get("time", 0.0)),
        )
        # Every reference UI control (src/ui/render_settings.rs:127-194)
        # is reachable here; static fields (integrator, iterations,
        # ladder) cost one recompile per new value, cached thereafter.
        cfg = RenderConfig(
            width=self.width,
            height=self.height,
            use_ladder=bool(req.get("ladder", False)),
            ladder=LadderConfig.for_resolution(self.width, self.height, 3),
            max_iterations=int(req.get("max_iter", self.max_iterations)),
            step_size=float(req.get("step_size", 0.15)),
            integrator=(
                Integrator.RK45
                if req.get("integrator") == "rk45"
                else Integrator.EULER
            ),
            march_mode=self.march_mode,
            geodesics="kerr" if req.get("kerr") else "pseudo",
            show_disk=bool(req.get("show_disk", True)),
            show_disk_texture=bool(req.get("show_texture", True)),
            show_redshift=bool(req.get("show_redshift", True)),
            show_sky=bool(req.get("show_sky", True)),
            bloom=BloomConfig(
                enabled=bool(req.get("bloom", True)),
                mix_ratio=float(req.get("mix_ratio", 0.7)),
            ),
            fxaa=FxaaConfig(enabled=bool(req.get("fxaa", True))),
            tonemap=bool(req.get("tonemap", True)),
        )
        return scene, cfg

    def render_frame(self, req: dict):
        """Render one frame; returns (png_bytes, stats_dict).  Stats are
        per-request (returned, not read back from shared state) so
        concurrent clients never see each other's frame timings."""
        from bhx.io import to_uint8
        from bhx.pipeline import render_jit

        with self._lock:
            scene, cfg = self._scene_cfg_from_request(req)
            import time as _time

            t0 = _time.perf_counter()
            img = to_uint8(np.asarray(render_jit(scene, cfg)))
            dt = _time.perf_counter() - t0
            # Device-side throughput for the status line (first call after
            # a static-setting change includes the compile — the status
            # shows that honestly, like the reference's frame timer).
            stats = {
                "mrays_per_s": round(self.width * self.height / dt / 1e6, 5),
                "frame_s": round(dt, 3),
            }
            self.last_stats = stats
        from bhx.io import encode_png

        return encode_png(img), stats

    def overflow_stats(self, req: dict) -> dict:
        """K-slot crossing-drop accounting for the current settings
        (tracer.crossing_overflow_stats) at a coarse resolution — the
        viewer's on-demand diagnostic for the record-don't-shade design.
        Only meaningful (and only computed) in pallas march modes."""
        if self.march_mode not in ("pallas", "pallas_interpret"):
            return {"overflow_frac": 0.0, "note": "jnp march composites unboundedly"}
        import dataclasses as _dc

        import jax

        from bhx.tracer import crossing_overflow_stats

        with self._lock:
            # SAME request decoding as /render (ADVICE r4: the diagnostic
            # must reflect the frame being viewed — disk tilt, step size,
            # integrator, every panel setting), then overridden down to a
            # coarse dense probe: the overflow fraction is a
            # scene-geometry property, not a pixel-grid one.
            scene, cfg = self._scene_cfg_from_request(req)
            w, h = min(self.width, 320), min(self.height, 180)
            cfg = _dc.replace(
                cfg, width=w, height=h, use_ladder=False,
                max_iterations=min(cfg.max_iterations, 800),
            )
            stats = jax.jit(
                lambda s: crossing_overflow_stats(s, cfg, w, h)
            )(scene)
            return {
                "overflow_frac": round(float(stats["overflow_frac"]), 5),
                "dropped_total": int(stats["dropped_total"]),
                "max_count": int(stats["max_count"]),
            }


def serve(host="127.0.0.1", port=8089, **kw):
    """Start the viewer (blocking).  ``python -m bhx.viewer``."""
    import bhx

    bhx.enable_compile_cache()  # app entry point opts in (ADVICE r4)
    server = ViewerServer(**kw)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/stats":
                    body = json.dumps(server.overflow_stats(req)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                png, stats = server.render_frame(req)
            except Exception as e:  # surface render/parse errors to the client
                self.send_response(500)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("X-Bhx-Stats", json.dumps(stats))
            self.end_headers()
            self.wfile.write(png)

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"bhx viewer on http://{host}:{port}")
    httpd.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8089)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    args = ap.parse_args()
    serve(port=args.port, width=args.width, height=args.height)
