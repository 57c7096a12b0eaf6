"""Proof submission service over HTTP (stdlib only).

The reference *declares* `ProofSubmissionService.SubmitProof` in
aero-sdk/proto/service.proto but never implements it (SURVEY.md §2.7).
This is a working daemon: protobuf `ProofSubmissionRequest` bytes POSTed
to /submit_proof are VERIFIED (full STARK verification, all queries) and
answered with a `ProofSubmissionResponse` receipt binding proof + public
inputs; invalid proofs get HTTP 400 with the verification error.

    server = SubmissionServer(port=0)        # 0 = ephemeral
    server.start()                           # background thread
    receipt = submit_proof_remote(f"http://127.0.0.1:{server.port}", req)
    server.stop()

or standalone:  python -m aero_tpu_torch.sdk.server --port 8600
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.request import Request, urlopen
from urllib.error import HTTPError

from . import ProofSubmissionService
from .pb import aero_pb2 as pb


class _Handler(BaseHTTPRequestHandler):
    service: ProofSubmissionService  # set on the server class

    def do_POST(self):
        if self.path != "/submit_proof":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        try:
            req = pb.ProofSubmissionRequest()
            req.ParseFromString(body)
            resp = self.server.service.submit_proof(req)  # type: ignore
        except Exception as e:  # verification or parse failure
            msg = str(e).encode()
            self.send_response(400)
            self.send_header("Content-Length", str(len(msg)))
            self.end_headers()
            self.wfile.write(msg)
            return
        out = resp.SerializeToString()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-protobuf")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, fmt, *args):  # quiet by default
        pass


class SubmissionServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.service = ProofSubmissionService()  # type: ignore
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


class SubmissionError(Exception):
    pass


def submit_proof_remote(base_url: str,
                        request: pb.ProofSubmissionRequest) -> str:
    """POST a submission to a running SubmissionServer; returns the receipt.
    Raises SubmissionError when the server rejects the proof."""
    req = Request(base_url.rstrip("/") + "/submit_proof",
                  data=request.SerializeToString(),
                  headers={"Content-Type": "application/x-protobuf"})
    try:
        with urlopen(req, timeout=120) as r:
            resp = pb.ProofSubmissionResponse()
            resp.ParseFromString(r.read())
            return resp.receipt
    except HTTPError as e:
        raise SubmissionError(e.read().decode(errors="replace")) from e


def main():
    import argparse
    ap = argparse.ArgumentParser(description="aero-tpu proof submission service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8600)
    args = ap.parse_args()
    server = SubmissionServer(args.host, args.port)
    print(f"submission service on http://{args.host}:{server.port}/submit_proof")
    server._httpd.serve_forever()


if __name__ == "__main__":
    main()
