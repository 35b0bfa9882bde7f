"""Gateway quickstart on PyTorch: the archive service on the wire.

Spins up a loopback `GatewayServer` over a small generated corpus and walks
the whole wire surface: authenticated opens, range reads (the paper's O(range)
random access, now per HTTP request), chunked streaming, a gateway-backed
training dataset, tenant flood -> 429 backpressure, and a mid-stream client
disconnect whose speculation is cancelled end to end (watch the scheduler's
``cancelled`` counter).

The counterpart of ``examples/serve_gateway.py``, step for step, on
``repro_torch``: the gateway's ``ArchiveServer`` and the gateway-backed
dataset run stage 2 on the card by default (``--device cpu`` runs the
kernels' plain versions on the host).

    PYTHONPATH=src python examples/serve_gateway_torch.py
    PYTHONPATH=src python examples/serve_gateway_torch.py --device cpu
    PYTHONPATH=src python examples/serve_gateway_torch.py --trace
        # ... writes a Chrome trace-event JSON on exit; load it in
        # Perfetto / chrome://tracing to see every demo request's spans
    PYTHONPATH=src python examples/serve_gateway_torch.py --port 8080 --keep
        # ... then from another shell:
        # curl -H 'Authorization: Bearer demo-token' \
        #      -H 'Range: bytes=1000-1999' \
        #      http://127.0.0.1:8080/v1/archives/f1/bytes
        # curl http://127.0.0.1:8080/metrics   # Prometheus exposition
"""

import argparse
import gzip
import http.client
import os
import socket
import tempfile
import time

import numpy as np

from repro_torch.data.pipeline import GzipCorpusDataset
from repro_torch.service import format_summary
from repro_torch.service.gateway import GatewayClient, GatewayServer, TenantAdmission
from repro_torch.service.gateway.admission import TenantLimit


def make_corpus(tmpdir: str, n_shards: int = 2, shard_kb: int = 512):
    rng = np.random.default_rng(11)
    words = [b"the", b"gateway", b"serves", b"decompressed", b"bytes",
             b"over", b"plain", b"http", b"range", b"requests"]
    paths = []
    for s in range(n_shards):
        n = shard_kb << 10
        doc = b" ".join(words[i] for i in rng.integers(0, len(words), n // 6))[:n]
        path = os.path.join(tmpdir, f"corpus-{s:02d}.txt.gz")
        with open(path, "wb") as f:
            f.write(gzip.compress(doc, 6))
        paths.append(path)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--keep", action="store_true",
                    help="keep serving until Ctrl-C (for curl exploration)")
    ap.add_argument("--trace", action="store_true",
                    help="enable request tracing; dump a Chrome trace-event "
                         "JSON (open in Perfetto) on exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the server's and the dataset's stage 2 runs")
    args = ap.parse_args()

    if args.trace:
        from repro_torch import obs
        obs.enable_tracing()

    tmpdir = tempfile.mkdtemp(prefix="gateway_demo_")
    paths = make_corpus(tmpdir)

    admission = TenantAdmission(
        tokens={"demo-token": "demo", "noisy-token": "noisy"},
        default_tenant=None,                      # auth required
        limits={"noisy": TenantLimit(max_in_flight=1, max_queued=1)},
        quanta={"demo": 2.0},                     # demo pays for 2x quantum
        retry_after=0.5,
    )
    with GatewayServer(
        port=args.port,
        admission=admission,
        open_roots=[tmpdir],                      # jail opens to the corpus
        cache_budget_bytes=16 << 20,
        max_workers=4,
        chunk_size=128 << 10,
        stream_span=128 << 10,
        device=args.device,
    ) as gw:
        print(f"gateway listening on {gw.url}")

        # -- FileReader over the wire ------------------------------------
        client = GatewayClient(gw.url, source=paths[0], token="demo-token")
        print(f"opened {paths[0]} as handle {client.handle}, "
              f"decompressed size {client.size()} bytes, etag {client.etag}")
        page = client.pread(1000, 200)
        print(f"pread(1000, 200) -> {page[:40]!r}...")
        streamed = sum(len(chunk) for chunk in client.stream())
        print(f"chunked full stream -> {streamed} bytes")

        # -- a training dataset pointed at the gateway --------------------
        ds = GzipCorpusDataset(
            ["gateway+" + gw.bytes_url(client.handle)],
            seq_len=128, batch_size=2, loop=False,
            remote_options={"headers": {"Authorization": "Bearer demo-token"}},
            device=args.device,
        )
        batch = ds.next_batch()
        print(f"gateway-backed dataset batch: {batch['tokens'].shape}")
        ds.close()

        # -- tenant flood: bounded, answered with 429 ---------------------
        host, port = gw.url[len("http://"):].rsplit(":", 1)
        noisy = GatewayClient(gw.url, source=paths[1], token="noisy-token")
        codes = []
        import threading

        def flood():
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            try:
                conn.request("GET", f"/v1/archives/{noisy.handle}/bytes",
                             headers={"Authorization": "Bearer noisy-token"})
                resp = conn.getresponse()
                resp.read()
                codes.append(resp.status)
            finally:
                conn.close()

        threads = [threading.Thread(target=flood) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"flooding tenant saw statuses: {sorted(codes)} "
              f"(429 = admission backpressure, Retry-After set)")

        # -- mid-stream disconnect: cancelled end to end ------------------
        s = socket.create_connection((host, int(port)), timeout=10)
        s.sendall(b"GET /v1/archives/%s/bytes HTTP/1.1\r\nHost: demo\r\n"
                  b"Authorization: Bearer demo-token\r\n\r\n"
                  % client.handle.encode())
        s.recv(2048)  # first chunk of the stream
        s.close()     # ... and we are gone
        time.sleep(0.3)

        print("\n--- gateway telemetry ---")
        print(format_summary(gw.metrics()))

        if args.keep:
            print("\nserving until Ctrl-C ...")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
        noisy.close()
        client.close()

    if args.trace:
        trace_path = os.path.join(tmpdir, "gateway_trace.json")
        trace = obs.dump_trace(trace_path)
        print(f"\nwrote {len(trace['traceEvents'])} trace events to "
              f"{trace_path} (load in Perfetto / chrome://tracing)")


if __name__ == "__main__":
    main()
