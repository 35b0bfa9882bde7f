"""repro_torch stage-2 kernels against the JAX package.

On the CPU the wrappers run the plain PyTorch versions; they are held, exact
to the bit, against the Pallas kernels in interpret mode, the jnp oracles,
the host marker path and zlib. The hand kernels are held against the plain
versions on the card in ``test_torch_cuda.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.markers import replace_markers
from repro.kernels import crc32 as jcrc
from repro.kernels.marker_replace import marker_replace_tiles as pallas_tiles
from repro.kernels.marker_replace import marker_replace_tiles_multi as pallas_tiles_multi
from repro.kernels import ref as jref
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import marker_replace as tmr
from repro_torch.kernels import ref as tref

TABLE_SIZE = 256 + 32768


def rng_for(*key):
    return np.random.default_rng(list(key))


def rand_tables(rng, n_tables):
    windows = [rng.integers(0, 256, 32768, dtype=np.uint8).tobytes() for _ in range(n_tables)]
    return windows, torch.stack([tref.make_replacement_table(w) for w in windows])


def rand_tiles(rng, n_tiles, hi=TABLE_SIZE):
    return rng.integers(0, hi, (n_tiles, tmr.TILE_ROWS, tmr.TILE_COLS), dtype=np.int64)


# ---------------------------------------------------------------------------
# constant tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wlen", [0, 1, 300, 32768, 40000])
def test_replacement_table_matches_reference(wlen):
    window = rng_for(1, wlen).integers(0, 256, wlen, dtype=np.uint8)
    ours = tref.make_replacement_table(window.tobytes())
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (TABLE_SIZE,)
    np.testing.assert_array_equal(ours.numpy().astype(np.int32), jref.make_replacement_table(window))


def test_crc_table_matches_reference():
    ours = tref.make_crc_table()
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcrc.make_crc_table()))


# ---------------------------------------------------------------------------
# marker replacement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiles,n_tables", [(1, 1), (3, 2), (4, 4)])
def test_marker_multi_matches_pallas(n_tiles, n_tables):
    rng = rng_for(2, n_tiles, n_tables)
    _, tables = rand_tables(rng, n_tables)
    syms = rand_tiles(rng, n_tiles)
    tids = rng.integers(0, n_tables, n_tiles, dtype=np.int64).astype(np.int32)
    ours = tmr.marker_replace_tiles_multi(
        torch.from_numpy(syms.astype(np.uint16)), tables, torch.from_numpy(tids)
    )
    assert ours.dtype == torch.uint8
    jt = jnp.asarray(tables.numpy().astype(np.int32))
    js, jtid = jnp.asarray(syms.astype(np.int32)), jnp.asarray(tids)
    pallas = np.asarray(pallas_tiles_multi(js, jt, jtid, interpret=True))
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jref.marker_replace_multi_ref(js, jt, jtid)))


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_marker_single_matches_pallas(n_tiles):
    rng = rng_for(3, n_tiles)
    _, tables = rand_tables(rng, 1)
    syms = rand_tiles(rng, n_tiles)
    ours = tmr.marker_replace_tiles(torch.from_numpy(syms.astype(np.uint16)), tables[0])
    jt, js = jnp.asarray(tables[0].numpy().astype(np.int32)), jnp.asarray(syms.astype(np.int32))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(pallas_tiles(js, jt, interpret=True))
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jref.marker_replace_ref(js, jt)))


@pytest.mark.parametrize("n", [1, 1000, 8192, 8192 + 17])
def test_marker_tiles_match_host_path(n):
    """A symbol stream padded into tiles resolves to what the host marker
    path of the reference gives."""
    rng = rng_for(4, n)
    window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    syms = rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)
    n_tiles = -(-n // tmr.TILE)
    tiles = np.zeros(n_tiles * tmr.TILE, np.uint16)
    tiles[:n] = syms
    out = tmr.marker_replace_tiles(
        torch.from_numpy(tiles.reshape(n_tiles, tmr.TILE_ROWS, tmr.TILE_COLS)),
        tref.make_replacement_table(window),
    )
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:n], replace_markers(syms, window))


def test_marker_out_of_range_gives_zero():
    """Pad lanes may hold anything: symbols >= TABLE_SIZE and table ids
    outside [0, n_tables) resolve to 0 instead of reading out of bounds."""
    rng = rng_for(5)
    _, tables = rand_tables(rng, 2)
    syms = rand_tiles(rng, 3, hi=1 << 16)
    tids = np.array([0, 2, -1], np.int32)
    out = tmr.marker_replace_tiles_multi(
        torch.from_numpy(syms.astype(np.uint16)), tables, torch.from_numpy(tids)
    ).numpy()
    assert not out[1:].any()
    big = syms[0] >= TABLE_SIZE
    assert big.any() and not out[0][big].any()
    np.testing.assert_array_equal(out[0][~big], tables[0].numpy()[syms[0][~big]])


@pytest.mark.parametrize(
    "shape,dtype,error",
    [
        ((2, 8, 1000), torch.uint16, ValueError),
        ((2, 8, 1024), torch.int32, TypeError),
    ],
)
def test_marker_wrapper_rejects_bad_input(shape, dtype, error):
    _, tables = rand_tables(rng_for(6), 1)
    with pytest.raises(error):
        tmr.marker_replace_tiles_multi(
            torch.zeros(shape, dtype=dtype), tables, torch.zeros(shape[0], dtype=torch.int32)
        )


# ---------------------------------------------------------------------------
# crc32
# ---------------------------------------------------------------------------

def lanes_crc(out):
    return np.asarray(out).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("batch,seg_len", [(1, 1), (2, 7), (4, 16)])
def test_crc_batched_matches_pallas(batch, seg_len):
    data = rng_for(7, batch, seg_len).integers(
        0, 256, (batch, tcrc.SEG_ROWS, tcrc.SEG_COLS, seg_len), dtype=np.uint8
    )
    ours = tcrc.crc32_segments_batched(torch.from_numpy(data), tref.make_crc_table())
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (batch, 8, 128)
    jd = jnp.asarray(data.astype(np.int32))
    pallas = jcrc.crc32_segments_batched(jd, jcrc.make_crc_table(), interpret=True)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(pallas))
    oracle = jref.crc32_segments_batched_ref(jd, jcrc.make_crc_table())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("seg_len", [1, 7, 64])
def test_crc_single_matches_pallas(seg_len):
    data = rng_for(8, seg_len).integers(0, 256, (8, 128, seg_len), dtype=np.uint8)
    ours = tcrc.crc32_segments(torch.from_numpy(data), tref.make_crc_table())
    jd = jnp.asarray(data.astype(np.int32))
    pallas = jcrc.crc32_segments(jd, jcrc.make_crc_table(), interpret=True)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jref.crc32_segments_ref(jd, jcrc.make_crc_table()))
    )


def test_crc_every_lane_matches_zlib():
    data = rng_for(9).integers(0, 256, (2, 8, 128, 33), dtype=np.uint8)
    ours = lanes_crc(tcrc.crc32_segments_batched(torch.from_numpy(data), tref.make_crc_table()))
    flat = data.reshape(-1, 33)
    want = [zlib.crc32(flat[i].tobytes()) for i in range(flat.shape[0])]
    np.testing.assert_array_equal(ours.reshape(-1), want)


def test_crc_wrapper_rejects_int32_bytes():
    with pytest.raises(TypeError):
        tcrc.crc32_segments_batched(torch.zeros((1, 8, 128, 4), dtype=torch.int32),
                                    tref.make_crc_table())
