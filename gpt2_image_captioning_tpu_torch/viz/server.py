"""Results viewer: generated against reference captions over the images — the
counterpart of ``gpt2_image_captioning_tpu/viz/server.py``; a
dependency-free, self-hosted gallery:

- :func:`create_captioning_dataset` — join predictions with ground-truth
  annotations (and optional per-image metrics) into a list of samples.
- :func:`launch_app` — serve a single-page gallery at ``localhost:5151``
  with images, generated caption, reference captions, per-image metric
  chips, search and paging.

Images are served straight from ``images_dir`` (paths that resolve outside
it are refused); nothing is copied.
"""

from __future__ import annotations

import html
import json
import os
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from typing import Any


def create_captioning_dataset(
    predictions_path: str,
    images_dir: str,
    annotations_path: str,
    metrics: dict[int, dict[str, float]] | None = None,
    dataset_name: str = "captioning-results",
) -> list[dict[str, Any]]:
    """Join predictions + references (+ optional per-image metrics) into
    viewer samples: {image_id, file_name, generated, references, metrics}."""
    with open(predictions_path) as f:
        preds = json.load(f)
    with open(annotations_path) as f:
        coco = json.load(f)

    id_to_file = {im["id"]: im.get("file_name") for im in coco.get("images", [])}
    refs: dict[int, list[str]] = {}
    for a in coco["annotations"]:
        refs.setdefault(a["image_id"], []).append(a["caption"])

    samples = []
    for p in preds:
        iid = p["image_id"]
        fname = id_to_file.get(iid) or f"{iid:012d}.jpg"
        samples.append(
            {
                "image_id": iid,
                "file_name": fname,
                "exists": os.path.exists(os.path.join(images_dir, fname)),
                "generated": p["caption"],
                "references": refs.get(iid, []),
                "metrics": (metrics or {}).get(iid, {}),
            }
        )
    print(f"Dataset '{dataset_name}': {len(samples)} samples")
    return samples


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Caption results</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 0; background: #111; color: #eee; }}
 header {{ padding: 12px 20px; background: #1b1b1b; position: sticky; top: 0;
           display: flex; gap: 16px; align-items: center; }}
 input {{ background: #222; color: #eee; border: 1px solid #444; padding: 6px 10px;
          border-radius: 6px; width: 320px; }}
 .grid {{ display: grid; grid-template-columns: repeat(auto-fill, minmax(320px, 1fr));
          gap: 14px; padding: 16px; }}
 .card {{ background: #1c1c1c; border-radius: 10px; overflow: hidden; }}
 .card img {{ width: 100%; height: 220px; object-fit: cover; background: #000; }}
 .card .body {{ padding: 10px 12px; }}
 .gen {{ color: #7fd4ff; font-weight: 600; margin-bottom: 6px; }}
 .ref {{ color: #aaa; font-size: 13px; margin: 2px 0; }}
 .chips {{ margin-top: 6px; }}
 .chip {{ display: inline-block; background: #333; border-radius: 10px; padding: 2px 8px;
          font-size: 11px; margin-right: 4px; color: #9f9; }}
 .missing {{ height: 220px; display: flex; align-items: center; justify-content: center;
             color: #666; }}
 footer {{ padding: 14px; text-align: center; color: #888; }}
 button {{ background: #333; color: #eee; border: 0; padding: 6px 14px; border-radius: 6px;
           cursor: pointer; }}
</style></head>
<body>
<header>
  <strong>Caption results</strong>
  <input id="q" placeholder="search captions / image id..." oninput="render()">
  <span id="count"></span>
</header>
<div class="grid" id="grid"></div>
<footer><button onclick="more()">Load more</button></footer>
<script>
const SAMPLES = {samples_json};
let shown = 60;
function matches(s, q) {{
  if (!q) return true;
  q = q.toLowerCase();
  return s.generated.toLowerCase().includes(q) ||
         s.references.some(r => r.toLowerCase().includes(q)) ||
         String(s.image_id).includes(q);
}}
function card(s) {{
  const img = s.exists ? `<img loading="lazy" src="/images/${{s.file_name}}">`
                       : `<div class="missing">image not found</div>`;
  const refs = s.references.slice(0, 5).map(r => `<div class="ref">— ${{esc(r)}}</div>`).join("");
  const chips = Object.entries(s.metrics).map(
      ([k, v]) => `<span class="chip">${{k}}: ${{(+v).toFixed(3)}}</span>`).join("");
  return `<div class="card">${{img}}<div class="body">
      <div class="gen">${{esc(s.generated)}}</div>${{refs}}
      <div class="chips">${{chips}}</div>
      <div class="ref" style="margin-top:6px">id ${{s.image_id}}</div></div></div>`;
}}
function esc(t) {{ const d = document.createElement('div'); d.innerText = t; return d.innerHTML; }}
function render() {{
  const q = document.getElementById('q').value;
  const filtered = SAMPLES.filter(s => matches(s, q));
  document.getElementById('grid').innerHTML =
      filtered.slice(0, shown).map(card).join("");
  document.getElementById('count').innerText =
      `${{Math.min(shown, filtered.length)}} / ${{filtered.length}} shown`;
}}
function more() {{ shown += 60; render(); }}
render();
</script>
</body></html>
"""


def launch_app(
    samples: list[dict[str, Any]],
    images_dir: str,
    port: int = 5151,
    open_browser: bool = False,
    blocking: bool = True,
):
    """Serve the gallery at http://localhost:{port} (FiftyOne's default port)."""
    page = _PAGE.format(samples_json=json.dumps(samples))
    images_dir = os.path.abspath(images_dir)

    class Handler(SimpleHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/images/"):
                fname = self.path[len("/images/"):]
                full = os.path.abspath(os.path.join(images_dir, fname))
                # resolve before containment check (blocks ../ traversal)
                if not full.startswith(images_dir + os.sep) or not os.path.exists(full):
                    self.send_error(404)
                    return
                import mimetypes

                ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                with open(full, "rb") as f:
                    self.wfile.write(f.read())
            elif self.path in ("/", "/index.html"):
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"Caption viewer running at http://localhost:{port} (ctrl-c to stop)")
    if open_browser:
        import webbrowser

        webbrowser.open(f"http://localhost:{port}")
    if blocking:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    else:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server
