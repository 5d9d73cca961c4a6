"""Live training dashboard: a zero-dependency in-process HTTP server (port
of ihmr_tpu/utils/live_dashboard.py, the same page and JSON byte for byte).

The counterpart of the reference's visdom live monitoring (a server the
user opens in a browser to watch loss curves + image grids update during
training), on the standard library alone:

  * ``/``            — self-refreshing page: live loss chart (inline SVG,
                       no external JS) + the latest visual panels from the
                       Visualizer's web dir
  * ``/losses.json`` — the full loss history (the page polls this)
  * ``/images/...``  — the Visualizer's dumped panels

Start with ``--live_port`` on the train CLIs; rank-0 only.
"""


from __future__ import annotations

import json
import os
import os.path as osp
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

_PAGE = """<!doctype html><html><head><title>{name}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.5rem; background:#fafafa; }}
 h1 {{ font-size: 1.2rem; }}
 .imgs img {{ max-width: 260px; margin: 4px; border: 1px solid #ccc; }}
 #chart {{ background: #fff; border: 1px solid #ccc; }}
 .legend span {{ margin-right: 1em; font-size: .85rem; }}
</style></head><body>
<h1>{name} — live training monitor</h1>
<svg id="chart" width="900" height="320"></svg>
<div class="legend" id="legend"></div>
<h2 style="font-size:1rem">latest visuals</h2>
<div class="imgs" id="imgs"></div>
<script>
const COLORS = ["#1f77b4","#d62728","#2ca02c","#9467bd","#ff7f0e",
                "#8c564b","#e377c2","#7f7f7f","#bcbd22","#17becf"];
async function tick() {{
  try {{
    const r = await fetch('losses.json', {{cache: 'no-store'}});
    const data = await r.json();
    draw(data);
  }} catch (e) {{}}
  setTimeout(tick, 2000);
}}
function draw(data) {{
  const svg = document.getElementById('chart');
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  const names = Object.keys(data.series || {{}});
  if (!names.length) return;
  let xmax = 1e-9, ymax = 1e-9;
  for (const n of names) for (const [x, y] of data.series[n]) {{
    xmax = Math.max(xmax, x); ymax = Math.max(ymax, y);
  }}
  let out = '';
  for (let g = 1; g < 5; g++) {{
    const yy = H - 20 - (H - 40) * g / 5;
    out += `<line x1="40" y1="${{yy}}" x2="${{W - 10}}" y2="${{yy}}" stroke="#eee"/>`;
    out += `<text x="4" y="${{yy + 4}}" font-size="10">${{(ymax * g / 5).toPrecision(3)}}</text>`;
  }}
  names.forEach((n, i) => {{
    const pts = data.series[n].map(([x, y]) =>
      `${{40 + (W - 50) * x / xmax}},${{H - 20 - (H - 40) * y / ymax}}`).join(' ');
    out += `<polyline fill="none" stroke="${{COLORS[i % 10]}}" stroke-width="1.5" points="${{pts}}"/>`;
  }});
  svg.innerHTML = out;
  document.getElementById('legend').innerHTML = names.map((n, i) =>
    `<span style="color:${{COLORS[i % 10]}}">&#9632; ${{n}}</span>`).join('');
  document.getElementById('imgs').innerHTML = (data.images || []).map(f =>
    `<img src="images/${{f}}?t=${{Date.now()}}">`).join('');
}}
tick();
</script></body></html>"""


class LiveDashboard:
    """Threaded HTTP server over a Visualizer web dir + an in-memory loss
    history. Thread-safe ``update`` from the training loop."""

    def __init__(self, web_dir: str, name: str = "ihmr_tpu"):
        self.web_dir = web_dir
        self.name = name
        self._lock = threading.Lock()
        self._series: Dict[str, List] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    # ------------------------------------------------------------- data
    def update(self, step: float, errors: Dict[str, float]):
        """Append one telemetry point (step can be fractional epochs)."""
        with self._lock:
            for k, v in errors.items():
                self._series.setdefault(k, []).append([float(step), float(v)])

    def _snapshot(self) -> bytes:
        with self._lock:
            series = {k: v[-2000:] for k, v in self._series.items()}
        images: List[str] = []
        img_dir = osp.join(self.web_dir, "images")
        if osp.isdir(img_dir):
            files = sorted(os.listdir(img_dir))[-6:]
            images = [f for f in files if f.endswith((".png", ".jpg"))]
        return json.dumps({"series": series, "images": images}).encode()

    # ----------------------------------------------------------- server
    def start(self, port: int = 0) -> int:
        """Start serving on ``port`` (0 = ephemeral); returns the bound port."""
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body = _PAGE.format(name=dash.name).encode()
                    ctype = "text/html"
                elif path == "/losses.json":
                    body = dash._snapshot()
                    ctype = "application/json"
                elif path.startswith("/images/"):
                    fname = osp.basename(path[len("/images/"):])
                    full = osp.join(dash.web_dir, "images", fname)
                    if not osp.isfile(full):
                        self.send_error(404)
                        return
                    with open(full, "rb") as f:
                        body = f.read()
                    ctype = "image/png"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        thread.start()
        print(f"[live] training monitor at http://localhost:{self.port}/", flush=True)
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
