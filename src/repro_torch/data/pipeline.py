"""Gzip-corpus input pipeline: the paper's engine as a training substrate.

``GzipCorpusDataset`` streams documents out of gzip-compressed shards
through ``ParallelGzipReader`` (speculative parallel decompression +
prefetch), tokenizes, and packs fixed-length LM sequences. This is the
deployment the paper motivates (§1.1: Common-Crawl-scale ML pipelines).
Shards may be local paths, in-memory bytes, or ``http(s)://`` URLs —
remote shards stream through range-GET preads (core/remote.py) and are
never fully downloaded; with a warm ``index_store`` a restore seeks in
O(range) network traffic.

Shards can also point at a **network gateway** (service/gateway/): a
``gateway+http(s)://...`` URL naming a gateway ``/bytes`` endpoint, or a
`GatewayClient` instance. Gateway shards arrive *already decompressed* —
the archive service on the other end runs the paper's machinery and this
pipeline does positional reads over the wire — so checkpoint restores seek
in O(1) against the gateway's warm index, and a training fleet shares one
central decompression tier instead of N per-host ones.

Fault tolerance: the iterator state is (shard index, *decompressed byte
offset*, partial-buffer digest) — restoring seeks in O(1) through the seek
index instead of re-decompressing the shard prefix, the paper's random
access capability doing real work. State is saved/restored with the model
checkpoint (checkpoint/checkpoint.py).

In a multi-host deployment every host runs one pipeline over its own shard
subset (shard_id=process_index) and feeds its addressable devices;
decompression parallelism comes from the chunk fetcher's thread pool —
exactly the paper's architecture, one instance per host.

When several pipelines (or a pipeline and a serving path) share one host,
pass ``cache_pool``/``executor``/``index_store`` (service layer) so all
shard readers draw from one memory budget and one fair thread pool, and
shard seek-indexes persist across epochs and restarts instead of being
rebuilt by a speculative first pass each time the shard is reopened.

Adapted from the JAX package's ``data/pipeline.py`` in how stage 2 is
resolved. A port reader built without a resolver takes the process-wide
engine of its device, which cannot be steered. So ``GzipCorpusDataset``
takes ``device`` ("cuda" by default) and ``resolver`` and passes both to
every reader it opens: a pipeline that shares an ``ArchiveServer``'s pool,
executor and index store passes ``resolver=server.device_engine`` and runs
stage 2 on that server's engine. With ``device="cuda"`` and no card the
first shard open raises; the pipeline never falls back to the CPU. Batches
stay numpy ``int32``, as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.index import GzipIndex
from ..core.reader import ParallelGzipReader
from ..core.remote import RemoteFileReader, is_remote_url
from .tokenizer import ByteTokenizer, EOS


@dataclasses.dataclass
class PipelineState:
    shard_idx: int
    byte_offset: int  # decompressed offset within the current shard
    buffered_tokens: int  # tokens already emitted from the current read block

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(int(d["shard_idx"]), int(d["byte_offset"]), int(d["buffered_tokens"]))


class GzipCorpusDataset:
    """Packed LM batches from gzip shards, checkpointable and shardable."""

    def __init__(
        self,
        shards: Sequence[str],  # paths, http(s):// URLs, or bytes of .gz shards
        *,
        tokenizer: Optional[ByteTokenizer] = None,
        seq_len: int = 1024,
        batch_size: int = 8,
        parallelization: int = 4,
        chunk_size: int = 1 << 20,
        read_block: int = 1 << 20,
        shard_id: int = 0,
        num_shards: int = 1,
        indexes: Optional[Dict[int, GzipIndex]] = None,
        loop: bool = True,
        cache_pool=None,  # service.CachePool: shared memory budget
        executor=None,  # service.FairExecutor (or any Executor) to share threads
        index_store=None,  # service.IndexStore: persistent shard indexes
        tenant: Optional[str] = None,  # accounting id in the shared pool
        remote_options: Optional[Dict] = None,  # RemoteFileReader kwargs for URL shards
        codec: Optional[str] = None,  # format tag for all shards; None = per-shard probe
        device: str = "cuda",  # stage-2 device of the readers when no resolver is given
        resolver=None,  # stage-2 resolver of every reader, e.g. ArchiveServer.device_engine
    ):
        if not shards:
            raise ValueError("no shards")
        self.shards = list(shards)
        self.tokenizer = tokenizer or ByteTokenizer()
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.parallelization = parallelization
        self.chunk_size = chunk_size
        self.read_block = read_block
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.indexes = indexes or {}
        self.loop = loop
        self.cache_pool = cache_pool
        self.executor = executor
        self.index_store = index_store
        self.tenant = tenant or f"pipeline-shard{shard_id}"
        self.remote_options = dict(remote_options or {})
        self.codec = codec
        self.device = device
        self.resolver = resolver

        self._my_shards = [i for i in range(len(self.shards)) if i % num_shards == shard_id]
        if not self._my_shards:
            raise ValueError("shard_id has no shards")
        self.state = PipelineState(0, 0, 0)
        # ParallelGzipReader for local/remote gzip shards; a plain FileReader
        # of decompressed bytes for gateway shards (both serve pread).
        self._reader = None
        self._reader_owned = True  # False when the shard IS a client object
        self._reader_shard: Optional[int] = None
        self._reader_key: Optional[str] = None  # index-store key at open time
        self._token_buf = np.empty(0, np.int32)
        self._exhausted = False

    # -- reader management ---------------------------------------------------

    @staticmethod
    def _is_gateway_shard(source) -> bool:
        if isinstance(source, str):
            return source.startswith(("gateway+http://", "gateway+https://"))
        # Lazy import: only pipelines that actually use gateway shards pay it.
        from ..service.gateway.client import GatewayClient

        return isinstance(source, GatewayClient)

    def _open_gateway(self, source):
        """FileReader of a gateway shard's *decompressed* bytes.

        Decompression, caching, and index reuse all happen gateway-side;
        locally this is positional HTTP range reads — no gzip machinery, no
        pool registration, and checkpoint restores cost one range GET.
        """
        if isinstance(source, str):
            url = source[len("gateway+"):]
            return RemoteFileReader(url, **self.remote_options), True
        return source, False  # caller-owned GatewayClient: never close it

    def _open(self, local_idx: int):
        global_idx = self._my_shards[local_idx % len(self._my_shards)]
        if self._reader is not None and self._reader_shard == global_idx:
            return self._reader
        self._close_reader()
        source = self.shards[global_idx]
        if self._is_gateway_shard(source):
            self._reader, self._reader_owned = self._open_gateway(source)
            self._reader_shard = global_idx
            self._reader_key = None  # the gateway owns the seek index
            return self._reader
        if is_remote_url(source):
            # Open the remote backend once: the identity used for the warm
            # index lookup and the reader's reads then share one set of
            # open-time validators (one HEAD total), and the close-time put
            # below keys the index by the version that was actually read —
            # not by a fresh probe that could see a replaced object.
            source = RemoteFileReader(source, **self.remote_options)
        access_cache = prefetch_cache = None
        try:
            store_key = None
            if self.index_store is not None:
                # Codec-qualified key: a gzip shard and a zstd shard of the
                # same logical text must never share a stored index.
                store_key = self.index_store.key_for(source, codec=self.codec)
            index = self.indexes.get(global_idx)
            if index is None and store_key is not None:
                # Warm open: a stored index skips the speculative first pass.
                index = self.index_store.get(store_key)
            if self.cache_pool is not None:
                access_cache, prefetch_cache = self.cache_pool.reader_caches(self.tenant)
            executor = self.executor
            if executor is not None and hasattr(executor, "view"):
                executor = executor.view(self.tenant)
            self._reader = ParallelGzipReader(
                source,
                parallelization=self.parallelization,
                chunk_size=self.chunk_size,
                index=index,
                codec=self.codec,
                executor=executor,
                access_cache=access_cache,
                prefetch_cache=prefetch_cache,
                resolver=self.resolver,
                device=self.device,
            )
        except BaseException:
            # Don't leak pool registrations (or remote connections) when any
            # open step fails — key derivation and the warm-index lookup can
            # raise for remote shards too (e.g. a 503 burst).
            if access_cache is not None:
                access_cache.release()
                prefetch_cache.release()
            if source is not self.shards[global_idx]:
                source.close()
            raise
        self._reader_shard = global_idx
        self._reader_owned = True
        self._reader_key = store_key
        return self._reader

    def _close_reader(self) -> None:
        """Close the current shard reader, persisting its index if possible."""
        if self._reader is None:
            return
        if self._reader_key is not None and self._reader.index.finalized:
            self.index_store.put(self._reader_key, self._reader.index)
        if self._reader_owned:
            self._reader.close()
        self._reader = None
        self._reader_shard = None
        self._reader_key = None

    # -- iteration -------------------------------------------------------------

    def _refill(self) -> bool:
        """Read the next block of the corpus into the token buffer."""
        while True:
            if not self.loop and self._exhausted:
                return False
            reader = self._open(self.state.shard_idx)
            # Stateless positional read: no cursor on the reader, so a
            # pipeline sharing its shard reader with other consumers (e.g. a
            # serving path behind the same ArchiveServer budgets) never
            # races a seek+read pair.
            data = reader.pread(self.state.byte_offset, self.read_block)
            if not data:
                # next shard (wrapping if looping)
                nxt = self.state.shard_idx + 1
                if not self.loop and nxt >= len(self._my_shards):
                    self._exhausted = True
                    return False
                self.state = PipelineState(nxt % len(self._my_shards), 0, 0)
                continue
            tokens = self.tokenizer.encode(data, add_bos=self.state.byte_offset == 0, add_eos=False)
            skip = self.state.buffered_tokens
            if skip:
                tokens = tokens[skip:]
            self._token_buf = np.concatenate([self._token_buf, tokens])
            self.state.byte_offset += len(data)
            self.state.buffered_tokens = 0
            return True

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Packed {tokens: [B, seq_len+1]} batch (causal LM layout)."""
        need = self.batch_size * (self.seq_len + 1)
        while self._token_buf.shape[0] < need:
            if not self._refill():
                if self._token_buf.shape[0] == 0:
                    return None
                pad = np.full(need - self._token_buf.shape[0], EOS, np.int32)
                self._token_buf = np.concatenate([self._token_buf, pad])
        batch = self._token_buf[:need].reshape(self.batch_size, self.seq_len + 1).copy()
        self._token_buf = self._token_buf[need:]
        return {"tokens": batch}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    # -- checkpointing -----------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        # The buffer itself is not persisted; instead record how many tokens
        # of the current block were already consumed so restore can skip them.
        st = dataclasses.replace(self.state)
        # tokens consumed from past blocks = everything not in _token_buf
        return {
            **st.as_dict(),
            "pending_buffer": int(self._token_buf.shape[0]),
        }

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.state = PipelineState.from_dict(d)
        # Rewind to the start of the partially-consumed region: drop the
        # buffered remainder and re-read it (idempotent, O(1) via the index).
        pending = int(d.get("pending_buffer", 0))
        self.state.byte_offset = max(0, self.state.byte_offset - pending)
        self._token_buf = np.empty(0, np.int32)
        self._exhausted = False
        self._close_reader()

    def export_indexes(self) -> Dict[int, bytes]:
        """Seek indexes of every opened shard (reusable across restarts).

        Gateway shards export nothing — their index lives server-side.
        """
        out = {}
        if self._reader is not None and self._reader_shard is not None:
            index = getattr(self._reader, "index", None)
            if index is not None:
                out[self._reader_shard] = index.to_bytes()
        return out

    def close(self) -> None:
        self._close_reader()
