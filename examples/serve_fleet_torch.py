"""Fleet quickstart on PyTorch: a sharded archive service across three
gateway peers.

Spins up three loopback `GatewayServer` peers (each with its own
`ArchiveServer` + `IndexStore`, index fallbacks cross-wired) behind a
`FleetRouter`, then walks the fleet surface: rendezvous placement (each
archive lands on exactly one owner, every client agrees which), a mid-stream
owner kill with transparent exact-offset resume on the failover peer
(bit-identical bytes), membership ejection on the next probe sweep, and the
cross-node index exchange — a cold open on a peer that never saw the
archive imports the finalized seek index from whoever built it and does
zero speculative work.

The counterpart of ``examples/serve_fleet.py``, step for step, on
``repro_torch``: each peer's ``ArchiveServer`` runs stage 2 on the card by
default (``--device cpu`` runs the kernels' plain versions on the host).

    PYTHONPATH=src python examples/serve_fleet_torch.py
    PYTHONPATH=src python examples/serve_fleet_torch.py --device cpu
"""

import argparse

import gzip
import os
import tempfile
import time

import numpy as np

from repro_torch.service import ArchiveServer, IndexStore, format_summary
from repro_torch.service.fleet import FleetRouter, make_index_fallback
from repro_torch.service.gateway import GatewayClient, GatewayServer


def make_corpus(tmpdir: str):
    """A few small shards plus one big one (big enough to stream through)."""
    rng = np.random.default_rng(23)
    words = [rng.bytes(3) * 2 for _ in range(64)]
    paths = {}
    for name, n_words in (("small-0", 40_000), ("small-1", 40_000),
                          ("big", 1_200_000)):
        data = b" ".join(words[int(i)] for i in rng.integers(0, 64, n_words))
        path = os.path.join(tmpdir, f"{name}.txt.gz")
        with open(path, "wb") as f:
            f.write(gzip.compress(data, 5))
        paths[name] = (path, data)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where each peer's stage 2 runs")
    args = ap.parse_args()

    tmpdir = tempfile.mkdtemp(prefix="fleet_demo_")
    corpus = make_corpus(tmpdir)

    # -- three peers, each its own server + index store ---------------------
    stores, servers, gws = [], [], []
    for i in range(3):
        store = IndexStore(os.path.join(tmpdir, f"idx{i}"))
        srv = ArchiveServer(cache_budget_bytes=16 << 20, max_workers=2,
                            chunk_size=128 << 10, index_store=store,
                            device=args.device)
        stores.append(store)
        servers.append(srv)
        gws.append(GatewayServer(srv, stream_span=64 << 10).start())
    urls = [gw.url for gw in gws]
    # cross-node index exchange: every store asks the *other* peers on a miss
    for i, store in enumerate(stores):
        store.set_remote_fallback(make_index_fallback(urls, exclude=[urls[i]]))

    with FleetRouter(urls, probe_interval=0.5, eject_after=1) as router:
        # -- placement: each archive has one owner, chosen by content key ---
        print("== placement ==")
        for name, (path, _) in corpus.items():
            key = router.key_for(path)
            print(f"  {name}: key {key[:12]}… -> owner {router.owner(key)}")

        # -- kill the owner mid-stream: the read does not notice -----------
        print("\n== failover: kill the owner mid-stream ==")
        path, data = corpus["big"]
        client = router.open(path)
        owner = client.peer
        got, n, killed = [], 0, False
        for chunk in client.stream(read_size=64 << 10):
            got.append(chunk)
            n += len(chunk)
            if not killed and n >= 1 << 20:
                killed = True
                print(f"  killing owner {owner} at byte {n:,} …")
                next(gw for gw in gws if gw.url == owner).close()
        assert b"".join(got) == data, "stream bytes diverged!"
        print(f"  stream finished on {client.peer}: {n:,} bytes, "
              f"bit-identical (failovers={client.stats['failovers']}, "
              f"resumed={client.stats['resumed_streams']})")
        client.close()  # persists the finalized index on the survivor

        # -- membership notices on the next sweep ---------------------------
        router.membership.probe_once()
        snap = router.membership.snapshot()
        print(f"  membership: {snap['alive']}/{snap['total']} peers alive")

        # -- index exchange: a cold open elsewhere is warm -------------------
        print("\n== index exchange: cold open on a fresh peer ==")
        third = next(u for u in urls
                     if u != owner and u != client.peer)
        t0 = time.time()
        g = GatewayClient(third, source=path)
        dt = time.time() - t0
        stat = g.stat()
        peer_metrics = next(gw for gw in gws if gw.url == third).metrics()
        print(f"  open on {third}: {dt*1e3:.1f}ms, "
              f"index_was_warm={stat['index_was_warm']}, "
              f"speculative tasks="
              f"{peer_metrics['fleet']['fetcher']['nominal_tasks']} "
              f"(index fetched from a peer: "
              f"{peer_metrics['index_store']['remote_hits']} hit)")
        g.close()

        # -- fleet telemetry -------------------------------------------------
        print("\n== fleet metrics ==")
        snapshot = peer_metrics
        snapshot.update(router.metrics())
        print(format_summary(snapshot))

    for gw in gws:
        try:
            gw.close()
        except Exception:  # noqa: BLE001 - the killed owner is already down
            pass
    for srv in servers:
        srv.shutdown()


if __name__ == "__main__":
    main()
