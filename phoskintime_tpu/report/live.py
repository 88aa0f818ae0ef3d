"""Live optimization monitor: in-process HTTP dashboard.

Behavioral spec: reference ``global_model/optuna_solver.py`` (optional
optuna-dashboard thread on port 8081 for watching a running fit) — here a
dependency-free stdlib server usable with EVERY optimizer backend: pass a
:class:`LiveMonitor` as the ``callback=`` of :func:`run_global_fit` (or
call ``update`` yourself) and open the printed URL.

Endpoints:
  /            auto-refreshing HTML page (fetch-polls /state.json, draws
               per-objective convergence curves on a canvas)
  /state.json  full history: generation, per-objective minima, evals

The server runs on a daemon thread; the optimization loop only appends to
a list under a lock, so the device-side evaluation cadence is untouched.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>phoskintime-tpu live fit</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2em; background: #111;
        color: #ddd; }
 .stat { display: inline-block; margin-right: 2.5em; }
 .stat b { font-size: 1.6em; display: block; color: #7fd4ff; }
 canvas { background: #181818; border: 1px solid #333; margin-top: 1.5em; }
</style></head><body>
<h2>phoskintime-tpu &mdash; live fit</h2>
<div>
 <span class="stat"><b id="gen">-</b>generation</span>
 <span class="stat"><b id="evals">-</b>evaluations</span>
 <span class="stat"><b id="best">-</b>best &Sigma;F</span>
 <span class="stat"><b id="elapsed">-</b>elapsed</span>
</div>
<canvas id="c" width="900" height="320"></canvas>
<script>
const names = ["protein", "rna", "phospho"];
const colors = ["#7fd4ff", "#ffb36b", "#9dff8a"];
async function tick() {
  const s = await (await fetch("state.json")).json();
  if (s.history.length) {
    const last = s.history[s.history.length - 1];
    document.getElementById("gen").textContent = last.gen;
    document.getElementById("evals").textContent = s.n_evals;
    document.getElementById("best").textContent =
      last.f_min.reduce((a, b) => a + b, 0).toPrecision(5);
    document.getElementById("elapsed").textContent =
      s.elapsed.toFixed(0) + "s";
    draw(s.history);
  }
}
function draw(h) {
  const c = document.getElementById("c"), g = c.getContext("2d");
  g.clearRect(0, 0, c.width, c.height);
  const m = h[0].f_min.length;
  const all = h.flatMap(r => r.f_min).filter(v => v > 0);
  if (!all.length) return;
  const lo = Math.log10(Math.min(...all)), hi = Math.log10(Math.max(...all));
  const x = i => 40 + (c.width - 60) * i / Math.max(1, h.length - 1);
  const y = v => {
    const t = (Math.log10(Math.max(v, 1e-30)) - lo) / Math.max(1e-9, hi - lo);
    return c.height - 25 - (c.height - 50) * t;
  };
  for (let j = 0; j < m; j++) {
    g.strokeStyle = colors[j % colors.length];
    g.beginPath();
    h.forEach((r, i) => { i ? g.lineTo(x(i), y(r.f_min[j]))
                            : g.moveTo(x(i), y(r.f_min[j])); });
    g.stroke();
    g.fillStyle = g.strokeStyle;
    g.fillText(names[j] || ("f" + j), 50 + 80 * j, 15);
  }
}
setInterval(tick, 2000); tick();
</script></body></html>
"""


class LiveMonitor:
    """Callable fit monitor + HTTP server. Use as ``callback=`` in
    run_global_fit / run_unsga3, or call ``update(gen, X, F)`` directly."""

    def __init__(self, port: int = 8081, host: str = "127.0.0.1",
                 logger=None):
        self._lock = threading.Lock()
        self._history: list[dict] = []
        self._n_evals = 0
        self._t0 = time.time()
        self._httpd = None
        self._port = port
        self._host = host
        self._logger = logger

    # -- recording ---------------------------------------------------------
    def update(self, gen: int, X, F) -> None:
        F = np.asarray(F, float)
        with self._lock:
            self._n_evals += len(F)
            self._history.append({
                "gen": int(gen),
                "f_min": [float(v) for v in F.min(axis=0)],
                "f_mean": [float(v) for v in F.mean(axis=0)],
                "pop": int(len(F)),
            })

    __call__ = update

    def state(self) -> dict:
        with self._lock:
            return {"history": list(self._history),
                    "n_evals": self._n_evals,
                    "elapsed": time.time() - self._t0}

    # -- server ------------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> str:
        monitor = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html"
                elif self.path.lstrip("/") == "state.json":
                    body = json.dumps(monitor.state()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request spam
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        th = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        th.start()
        url = f"http://{self._host}:{self.port}/"
        if self._logger is not None:
            self._logger.info(f"[Live] fit monitor at {url}")
        return url

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
