"""
Interactive solver playground served over HTTP — the browser-based
counterpart of the reference's imviz optim-example GUIs (reference:
library/tpl/optim/examples/crane_2d/main.py:123-186).  Capability
parity, not a translation:

* the page polls ``/state.json`` (~10 Hz) and the server re-solves on
  every poll — the analog of ``opt.update()`` per imviz frame,
* **draggable handles** in the world plot write solver params (the
  reference's ``viz.drag_point`` / ``viz.drag_hline``),
* every scalar param gets a live number input (``viz.autogui``),
* a *simulate* toggle shifts the solution one step per frame —
  receding-horizon MPC on the example problem (``opt.shift(1)``),
* runtime / cost / per-handle error readouts, and a raw internals
  panel (``viz.autogui(opt)``) showing horizon, step, iterations and
  the current state/action matrices.

Problems plug in through a ``scene`` callback returning plot geometry,
so any :class:`tpl_tpu_torch.optim.solver.Solver` instance can be served —
see ``python -m tpl_tpu_torch.examples.crane_2d --gui``.

The port of ``tpl_tpu/gui/optim_view.py`` (host code; the imports renamed).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class Handle:
    """A draggable world-space handle bound to solver params.

    ``kind`` is ``"point"`` (free 2-D drag) or ``"hline"`` (vertical
    drag of a horizontal line).  ``get(opt) -> (x, y)`` places the
    handle; ``set(opt, x, y)`` writes the dragged position back into
    ``opt.params``."""

    def __init__(self, name, kind, get, set):
        self.name = name
        self.kind = kind
        self.get = get
        self.set = set


class OptimView:
    """Serve one solver instance as an interactive page.

    ``scene(opt) -> list`` returns drawables, each a dict:
    ``{"kind": "line"|"points", "xy": [[x, y], ...]}`` with optional
    ``"color"``, ``"fade"`` (alpha ramp along the polyline, the
    reference's fading rope-end trajectory) and ``"size"``.
    """

    def __init__(self, solver, scene=None, handles=(), title="optim",
                 host="127.0.0.1", port=8024):
        self.opt = solver
        self.scene = scene
        self.handles = list(handles)
        self.title = title
        self.host = host
        self.port = port
        self.sim_running = False
        self._lock = threading.Lock()
        self._httpd = None
        self._thread = None

    # -- one imviz frame: solve (+ shift when simulating) --------------

    def _frame(self):
        self.opt.update()
        if self.sim_running:
            self.opt.shift(1)

    def state_dict(self):
        with self._lock:
            self._frame()
            opt = self.opt
            params = {k: (v.tolist() if isinstance(v, np.ndarray)
                          else v)
                      for k, v in opt.params._values.items()}
            return {
                "title": self.title,
                "runtime_ms": float(opt.runtime),
                "cost": float(opt.traj_costs),
                "sim_running": self.sim_running,
                "params": params,
                "scene": self.scene(opt) if self.scene else [],
                "handles": [
                    {"name": h.name, "kind": h.kind,
                     "xy": [float(v) for v in h.get(opt)]}
                    for h in self.handles],
                "internals": {
                    "horizon": int(opt.horizon),
                    "step": float(opt.step),
                    "max_iterations": int(opt.max_iterations),
                    "x": np.asarray(opt.x).round(5).tolist(),
                    "u": np.asarray(opt.u).round(5).tolist(),
                },
            }

    def set_param(self, name, value):
        with self._lock:
            setattr(self.opt.params, name, value)

    def drag(self, name, x, y):
        with self._lock:
            for h in self.handles:
                if h.name == name:
                    h.set(self.opt, float(x), float(y))
                    return True
        return False

    # -- http ----------------------------------------------------------

    def start(self):
        view = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif self.path == "/state.json":
                    self._send(200, json.dumps(
                        view.state_dict()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/set":
                        view.set_param(req["name"], req["value"])
                    elif self.path == "/drag":
                        if not view.drag(req["name"], req["x"], req["y"]):
                            self._send(404, b'{"error": "no such handle"}')
                            return
                    elif self.path == "/sim":
                        view.sim_running = bool(req.get("running"))
                    else:
                        self._send(404, b"{}")
                        return
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, json.dumps(
                        {"error": f"bad request: {e}"}).encode())
                    return
                self._send(200, b"{}")

        self._httpd = ThreadingHTTPServer((self.host, self.port), H)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    def serve_forever(self):
        self.start()
        print(f"optim view: http://{self.host}:{self.port}/")
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>tpl-tpu optim</title><style>
body{font:13px sans-serif;background:#14161a;color:#ddd;margin:0;
display:flex}
#plot{background:#1c2026;margin:10px;border:1px solid #333}
#side{padding:10px;width:300px}
input{width:90px;background:#22262c;color:#ddd;border:1px solid #444}
label{display:inline-block;width:110px}
button{background:#2a6;border:0;color:#fff;padding:4px 10px;
cursor:pointer;margin-bottom:8px}
pre{font-size:10px;max-height:240px;overflow:auto;background:#1c2026;
padding:6px}
.row{margin:2px 0}</style></head><body>
<canvas id="plot" width="640" height="520"></canvas>
<div id="side"><h3 id="title">optim</h3>
<button id="simbtn" onclick="toggleSim()">start simulation</button>
<div id="stats"></div><div id="params"></div>
<h4>internals</h4><pre id="internals"></pre></div>
<script>
let st = null, dragging = null, simRunning = false;
const cv = document.getElementById('plot'),
      cx = cv.getContext('2d');
let world = {x0:-12, x1:12, y0:-12, y1:8};
function w2c(x, y){
  const sx = cv.width / (world.x1 - world.x0),
        sy = cv.height / (world.y1 - world.y0),
        s = Math.min(sx, sy);   // equal aspect
  const mx = (world.x0 + world.x1) / 2, my = (world.y0 + world.y1) / 2;
  return [cv.width/2 + (x-mx)*s, cv.height/2 - (y-my)*s];
}
function c2w(px, py){
  const sx = cv.width / (world.x1 - world.x0),
        sy = cv.height / (world.y1 - world.y0),
        s = Math.min(sx, sy);
  const mx = (world.x0 + world.x1) / 2, my = (world.y0 + world.y1) / 2;
  return [mx + (px - cv.width/2)/s, my - (py - cv.height/2)/s];
}
function draw(){
  if(!st) return;
  cx.clearRect(0,0,cv.width,cv.height);
  for(const d of st.scene){
    const col = d.color || '#ec5';
    if(d.kind === 'points'){
      cx.fillStyle = col;
      for(const [x,y] of d.xy){
        const [px,py] = w2c(x,y);
        cx.beginPath(); cx.arc(px,py,d.size||3,0,7); cx.fill();
      }
    } else {
      cx.strokeStyle = col; cx.lineWidth = d.size||1.5;
      for(let i=1;i<d.xy.length;i++){
        cx.globalAlpha = d.fade ?
          Math.pow(1 - i/d.xy.length, 2) : 1.0;
        cx.beginPath();
        cx.moveTo(...w2c(...d.xy[i-1])); cx.lineTo(...w2c(...d.xy[i]));
        cx.stroke();
      }
      cx.globalAlpha = 1.0;
    }
  }
  for(const h of st.handles){
    const [px,py] = w2c(...h.xy);
    cx.strokeStyle = '#fff'; cx.fillStyle = '#fff';
    if(h.kind === 'hline'){
      cx.setLineDash([6,6]);
      cx.beginPath();
      cx.moveTo(0,py); cx.lineTo(cv.width,py); cx.stroke();
      cx.setLineDash([]);
    } else {
      cx.beginPath(); cx.arc(px,py,6,0,7); cx.stroke();
    }
    cx.fillText(h.name, px+8, py-8);
  }
}
cv.onmousedown = e => {
  if(!st) return;
  for(const h of st.handles){
    const [px,py] = w2c(...h.xy);
    const near = h.kind === 'hline' ? Math.abs(e.offsetY-py) < 8 :
      Math.hypot(e.offsetX-px, e.offsetY-py) < 10;
    if(near){ dragging = h.name; break; }
  }
};
cv.onmousemove = e => {
  if(!dragging) return;
  const [x,y] = c2w(e.offsetX, e.offsetY);
  fetch('/drag', {method:'POST',
    body: JSON.stringify({name: dragging, x: x, y: y})});
};
cv.onmouseup = () => dragging = null;
function setParam(name, value){
  fetch('/set', {method:'POST',
    body: JSON.stringify({name: name, value: +value})});
}
function toggleSim(){
  simRunning = !simRunning;
  document.getElementById('simbtn').textContent =
    (simRunning ? 'stop' : 'start') + ' simulation';
  fetch('/sim', {method:'POST',
    body: JSON.stringify({running: simRunning})});
}
let paramsBuilt = false;
function buildParams(p){
  const el = document.getElementById('params');
  el.innerHTML = '<h4>params</h4>';
  for(const [k,v] of Object.entries(p)){
    if(Array.isArray(v)) continue;
    const row = document.createElement('div'); row.className = 'row';
    row.innerHTML = `<label>${k}</label>`;
    const inp = document.createElement('input');
    inp.type = 'number'; inp.step = 'any'; inp.value = v;
    inp.onchange = () => setParam(k, inp.value);
    row.appendChild(inp); el.appendChild(row);
  }
}
async function tick(){
  try{
    const r = await fetch('/state.json');
    st = await r.json();
    document.getElementById('title').textContent = st.title;
    document.getElementById('stats').innerHTML =
      `runtime: ${st.runtime_ms.toFixed(2)} ms<br>` +
      `cost: ${st.cost.toFixed(4)}`;
    if(!paramsBuilt){ buildParams(st.params); paramsBuilt = true; }
    document.getElementById('internals').textContent =
      JSON.stringify({horizon: st.internals.horizon,
                      step: st.internals.step,
                      max_iterations: st.internals.max_iterations,
                      x0: st.internals.x[0],
                      x_end: st.internals.x[st.internals.x.length-1]},
                     null, 1);
    draw();
  } catch(e) {}
  setTimeout(tick, 100);
}
tick();
</script></body></html>"""
