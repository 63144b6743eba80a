"""HTTP front end over the continuous-batching ``VQAServer``
(counterpart of ``vqacl_tpu/cli/serve_http.py``, the same endpoints and
payloads).

Standard library only (``http.server``): each connection gets a handler
thread that only submits to the shared ``VQAServer`` and waits on its
future, so concurrent requests coalesce into single eval-step calls, and
all CUDA work stays on the server's worker thread.

Endpoints:
  POST /v1/vqa     {"question": str, "img_id": str} -> {"answer": str}
                   or {"items": [{"question","img_id"}, ...]}
                   -> {"answers": [str, ...]}
  GET  /healthz    {"ok": true}
  GET  /stats      VQAServer.stats() (requests, batches, fill, latency)
  GET  /metrics    the same counters in Prometheus text exposition

Usage:
  python3 -m vqacl_tpu_torch.cli.serve_http --checkpoint snap/.../LAST \
      --coco_h5 datasets/COCO/features/train_obj36.h5 --port 8080
  python3 -m vqacl_tpu_torch.cli.serve_http --checkpoint snap/.../LAST \
      --pack features.vfpack --port 8080

``--coco_h5`` needs ``h5py``; ``--pack`` reads a pack written by
``data/packed_cache.py`` (either package's) and needs only ``g++``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from vqacl_tpu_torch.serve import VQAServer


def make_http_server(server: VQAServer, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` auto-picks."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):      # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            elif self.path == "/metrics":
                # Prometheus text exposition of the same counters
                st = server.stats()
                lines = []
                for k, v in st.items():
                    if v is None:
                        continue
                    lines.append(f"# TYPE vqa_{k} "
                                 f"{'counter' if k in ('requests', 'batches', 'errors') else 'gauge'}")
                    lines.append(f"vqa_{k} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/vqa":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            try:
                if "items" in req:
                    items = req["items"]
                    futs = [server.submit(it["question"], it["img_id"])
                            for it in items]
                    self._reply(200,
                                {"answers": [f.result() for f in futs]})
                else:
                    fut = server.submit(req["question"], req["img_id"])
                    self._reply(200, {"answer": fut.result()})
            except KeyError as e:
                self._reply(400, {"error": f"missing field/id: {e}"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # socketserver's listen backlog of 5 resets connections when more
        # clients connect at once than the accept thread takes in time
        request_queue_size = 128

    return Server((host, port), Handler)


def serve_forever_in_thread(httpd: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="vqa-http")
    t.start()
    return t


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="model checkpoint (.npz, as either package's CL "
                        "trainer writes it)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--coco_h5", default=None,
                     help="COCO *_obj36.h5 feature file (reference layout; "
                          "needs h5py)")
    src.add_argument("--pack", default=None,
                     help="feature pack (data/packed_cache.py)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="eval-step calls the dispatcher may run ahead of "
                        "the result copy (0 = synchronous; see "
                        "serve.VQAServer)")
    a = p.parse_args(argv)

    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.serve import VQAPredictor

    if a.pack:
        from vqacl_tpu_torch.data.packed_cache import PackedFeatureStore
        store = PackedFeatureStore(a.pack)
    else:
        from vqacl_tpu_torch.data.features import H5FeatureStore
        store = H5FeatureStore({"coco": a.coco_h5})
    pred = VQAPredictor.from_checkpoint(a.checkpoint, VLT5Tokenizer(),
                                        store, batch_size=a.batch_size,
                                        num_beams=a.num_beams)
    with VQAServer(pred, max_wait_ms=a.max_wait_ms,
                   pipeline_depth=a.pipeline_depth) as srv:
        httpd = make_http_server(srv, a.host, a.port)
        print(f"serving on http://{a.host}:{httpd.server_address[1]} "
              f"(batch {a.batch_size}, beams {a.num_beams}, "
              f"window {a.max_wait_ms} ms)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()


if __name__ == "__main__":
    main()
