"""stdlib HTTP server for the demo UI (no external web framework).

The port of ``tpu_zkpool/webui/server.py``. The reference serves its UI
through Next.js routes (``demo-frontend/app/api/relay/*`` + the React page);
here one ``ThreadingHTTPServer`` hosts both the static page (the port's own
copy, beside this module) and the JSON API, with the app logic in
``webui.app.DemoApp``.
"""

from __future__ import annotations

import argparse
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpu_zkpool_torch.webui.app import (DEFAULT_ARTIFACT, DEFAULT_RLWE_DIR,
                                        DEFAULT_STORE, PROVERS, DemoApp)

_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def make_handler(app: DemoApp):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict | bytes,
                  ctype: str = "application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(os.path.join(_STATIC, "index.html"), "rb") as f:
                    return self._send(200, f.read(), "text/html")
            code, payload = app.handle("GET", self.path, {})
            self._send(code, payload)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._send(400, {"error": "invalid JSON body"})
            code, payload = app.handle("POST", self.path, body)
            self._send(code, payload)

        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("TPUZK_WEBUI_LOG") == "1":
                super().log_message(fmt, *args)

    return Handler


def make_server(app: DemoApp, port: int = 8642,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(app))


def serve(port: int = 8642, **app_kwargs):
    app = DemoApp(**app_kwargs)
    srv = make_server(app, port)
    print(f"shielded-pool demo UI on http://127.0.0.1:{port} "
          f"(prover={app.prover}, device={app.device})", flush=True)
    srv.serve_forever()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--store", default=DEFAULT_STORE)
    ap.add_argument("--rlwe-dir", default=DEFAULT_RLWE_DIR,
                    help="directory with rlwe_pk.json and "
                         "rlwe_sk_shares/share_{1,2}.json (default: the "
                         "reference checkout's, from its root)")
    ap.add_argument("--prover", choices=PROVERS, default="stub",
                    help="groth16 = real withdraw proofs on the device from "
                         "the ACIR artifact (startup pays the setup)")
    ap.add_argument("--artifact", default=DEFAULT_ARTIFACT,
                    help="the withdraw circuit's ACIR artifact (.json) for "
                         "--prover groth16 (default: the reference "
                         "checkout's, from its root)")
    ap.add_argument("--device", default=None,
                    help="the Merkle tree's and the prover's device "
                         "(default cuda)")
    ap.add_argument("--fresh", action="store_true",
                    help="clear the persisted store on startup")
    args = ap.parse_args()
    serve(args.port, store_path=args.store, rlwe_dir=args.rlwe_dir,
          prover=args.prover, artifact=args.artifact, device=args.device,
          fresh=args.fresh)


if __name__ == "__main__":
    main()
