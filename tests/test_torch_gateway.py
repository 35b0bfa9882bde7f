"""repro_torch.service.gateway against the JAX package's gateway.

Two gateways on loopback, the port's ``GatewayServer(device="cpu")`` and
the reference's, serve the same archive. The same requests must get the
same status, ``Content-Range``, ``ETag`` and body; a byte-rate admission
limit must refuse the same request; ``/metrics`` must parse as Prometheus
text and carry the port's engine counters. A gateway asked for
``device="cuda"`` on a host without a card raises.
"""

import http.client
import json
import re
import time

import numpy as np
import pytest
import torch

import repro.service.gateway as ref_gateway
from conftest import gzip_bytes, make_base64, make_text
from repro_torch.service.gateway import GatewayClient, GatewayServer, TenantAdmission
from repro_torch.service.gateway.admission import TenantLimit

pytestmark = pytest.mark.gateway

SERVER = dict(cache_budget_bytes=2 << 20, max_workers=2, chunk_size=32 << 10)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    rng = np.random.default_rng(0x6A7F)
    data = make_text(rng, 90_000) + make_base64(rng, 90_000)
    path = tmp_path_factory.mktemp("torch_gateway") / "mixed.gz"
    path.write_bytes(gzip_bytes(data, 6))
    return str(path), data


@pytest.fixture(scope="module")
def gateways(archive):
    """(port gateway, its handle, reference gateway, its handle), each with
    the archive open and its first pass done."""
    path, data = archive
    port = GatewayServer(device="cpu", stream_span=64 << 10, **SERVER).start()
    ref = ref_gateway.GatewayServer(stream_span=64 << 10, **SERVER).start()
    clients = []
    try:
        for gw, client_cls in ((port, GatewayClient), (ref, ref_gateway.GatewayClient)):
            clients.append(client_cls(gw.url, source=path))
            assert clients[-1].size() == len(data)
        yield port, clients[0].handle, ref, clients[1].handle
    finally:
        for client in clients:
            client.close()  # its keep-alive connection would hold the gateway open
        port.close()
        ref.close()


def _request(gw, method, path, headers=None):
    host, port = gw.url[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


N = 180_000
RANGES = [
    "bytes=100-299",
    "bytes=-500",
    "bytes=%d-" % (N - 100),
    "bytes=0-%d" % (N + 50),
    "bytes=70000-140000",
    "bytes=%d-" % (N + 5),
    "bytes=300-200",
    "bytes=0-1,5-6",
    None,
]


@pytest.mark.parametrize("method", ["GET", "HEAD"])
@pytest.mark.parametrize("rng_header", RANGES)
def test_bytes_responses_match_reference(archive, gateways, method, rng_header):
    _, data = archive
    assert len(data) == N
    port, ph, ref, rh = gateways
    headers = {"Range": rng_header} if rng_header else {}
    got = _request(port, method, "/v1/archives/%s/bytes" % ph, headers)
    want = _request(ref, method, "/v1/archives/%s/bytes" % rh, headers)
    assert got[0] == want[0]
    for name in ("content-range", "content-length", "etag", "accept-ranges"):
        assert got[1].get(name) == want[1].get(name), name
    assert got[2] == want[2]
    if got[0] == 206 and method == "GET":
        start, stop = map(int, re.match(r"bytes (\d+)-(\d+)/", got[1]["content-range"]).groups())
        assert got[2] == data[start : stop + 1]


def test_stat_and_index_endpoints_match_reference(gateways):
    port, ph, ref, rh = gateways
    s_port, _, b_port = _request(port, "GET", "/v1/archives/%s/stat" % ph)
    s_ref, _, b_ref = _request(ref, "GET", "/v1/archives/%s/stat" % rh)
    assert s_port == s_ref == 200
    stat_port, stat_ref = json.loads(b_port), json.loads(b_ref)
    assert stat_port.pop("handle") == ph and stat_ref.pop("handle") == rh
    assert stat_port == stat_ref
    got = _request(port, "GET", "/v1/archives/%s/index" % ph)
    want = _request(ref, "GET", "/v1/archives/%s/index" % rh)
    assert got[0] == want[0] == 200
    assert got[1]["etag"] == want[1]["etag"] and got[2] == want[2]
    # By identity key the store answers, which holds no index yet.
    key = stat_port["identity"]
    got = _request(port, "GET", "/v1/archives/%s/index" % key)
    assert got[0] == _request(ref, "GET", "/v1/archives/%s/index" % key)[0] == 404


def test_byte_rate_admission_refuses_like_the_reference(archive):
    path, data = archive
    span = 32 << 10
    results = []
    for gw_cls, client_cls, adm_cls, limit_cls, kw in (
        (GatewayServer, GatewayClient, TenantAdmission, TenantLimit, {"device": "cpu"}),
        (ref_gateway.GatewayServer, ref_gateway.GatewayClient, ref_gateway.TenantAdmission,
         ref_gateway.admission.TenantLimit, {}),
    ):
        adm = adm_cls(
            tokens={"tok-m": "metered"},
            default_tenant=None,
            limits={"metered": limit_cls(max_in_flight=4, max_queued=4,
                                         byte_rate=1_000.0, byte_burst=span + 1_000)},
        )
        with gw_cls(admission=adm, **SERVER, **kw) as gw:
            client = client_cls(gw.url, source=path, token="tok-m")
            headers = {"Authorization": "Bearer tok-m", "Range": "bytes=0-%d" % (span - 1)}
            url = "/v1/archives/%s/bytes" % client.handle
            out = [_request(gw, "GET", url, headers) for _ in range(3)]
            anon = _request(gw, "GET", url, {"Range": "bytes=0-9"})[0]
            results.append(([s for s, _, _ in out], out[2][1].get("retry-after") is not None,
                            [b for _, _, b in out[:2]], anon, gw.metrics()["admission"]))
            client.close()
    port, ref = results
    assert port[:4] == ref[:4]
    assert port[0] == [206, 206, 429] and port[1] and port[3] == 401
    assert port[2] == [data[:span]] * 2
    assert set(port[4]) == set(ref[4])


def _prometheus(text):
    """name -> list of (labels, value) for every sample line."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$", line)
        assert m, line
        samples.setdefault(m.group(1), []).append((m.group(2) or "", float(m.group(3))))
    return samples


def test_prometheus_metrics_parse_and_carry_engine_counters(gateways):
    port, _, ref, _ = gateways
    s_port, h_port, body_port = _request(port, "GET", "/metrics")
    s_ref, _, body_ref = _request(ref, "GET", "/metrics")
    assert s_port == s_ref == 200
    assert h_port["content-type"].startswith("text/plain")
    got, want = _prometheus(body_port.decode()), _prometheus(body_ref.decode())
    engine = {n for n in got if n.startswith("repro_engine_")}
    assert engine == {n for n in want if n.startswith("repro_engine_")}
    # Scraped before this read of the same, monotone counter.
    assert 0 < got["repro_engine_batches"][0][1] <= port.server.device_engine.stats()["batches"]
    assert got["repro_engine_errors"][0][1] == 0
    # Names apart from the latency histograms (process-wide, per package).
    plain = lambda s: {n for n in s if "latency_seconds" not in n}  # noqa: E731
    assert plain(got) == plain(want)
    snap = json.loads(_request(port, "GET", "/v1/metrics")[2])
    assert snap["engine"]["interpret"] is True
    assert snap["engine"]["fallbacks"] == {"replace": 0, "crc": 0}


def test_gateway_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GatewayServer(**SERVER)
    with pytest.raises(RuntimeError, match="CUDA"):
        GatewayServer(device="cuda", **SERVER)


def test_close_returns_while_a_client_holds_its_connection(archive):
    """The port's gateway closes at once with a keep-alive client still
    connected (Python 3.12's ``wait_closed`` waits for open connections,
    so it must come after they are aborted), and shuts down the engine of
    the server it owns."""
    path, data = archive
    gw = GatewayServer(device="cpu", stream_span=64 << 10, **SERVER).start()
    engine = gw.server.device_engine
    client = GatewayClient(gw.url, source=path)
    try:
        assert client.pread(1000, 5000) == data[1000:6000]
        t0 = time.monotonic()
        gw.close()
        assert time.monotonic() - t0 < 1.0
        assert engine.stats()["closed"]
    finally:
        client.close()
        gw.close()
