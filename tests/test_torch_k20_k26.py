"""K26's bulk route in numpy, on the CPU: the tile walk of
``csrc/transpose_bench.cu`` (``bulk_tile_kernel`` for 32x32 and 64x64,
``bulk_slab_kernel`` for the slab) modelled step by step at small shapes and
the JAX one cut to an eighth.

The model fills each warp's slots with the bulk copies the kernel issues
(row i of a tile at ``slot_row``), drains them as the kernel's lanes do
(a 4 x 4 block a lane: four 16-byte shared loads, four 16-byte stores) and
walks the tiles, slots and barrier parities in the kernel's order.  It
checks that every output word is written once, with ``x.t()``'s word; that
the 16-byte shared loads of each quarter-warp hit eight distinct bank
groups; that every copy and store is 16-byte aligned exactly where the
wrapper picks the bulk route (``K26.route``); and that each tiling's
shared memory fits the card.  Needs no card.
"""

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import hardware
from tpu_viterbi_torch.scripts import transpose_bench as tb

SHAPES = [(96, 80), (33, 130), (1, 1), (1968, 1056), (64, 102), (36, 132)]
# persistent grids: one CTA, a few, and more CTAs than the work
GRIDS = (1, 3, 1000)
SMS = 132


def bank_groups(addrs: np.ndarray) -> np.ndarray:
    """The 16-byte bank group (of 8: 32 banks of 4 bytes) of each address."""
    return (addrs // 16) % 8


class Walk:
    """One run of the bulk route's model on ``x`` with ``grid`` CTAs:
    ``out`` the transposed words (-1 where none was written), ``writes``
    the stores of each output word, ``loads`` the byte offsets of every
    quarter-warp's 16-byte shared loads, ``copies`` (global byte offset,
    bytes) of every bulk copy and ``stores`` the global byte offset of every
    16-byte store."""

    def __init__(self, tiling: str, x: np.ndarray, grid: int):
        self.t = tb.TILE[tiling]
        self.x = x
        self.rows, self.cols = x.shape
        self.out = np.full((self.cols, self.rows), -1, dtype=np.int64)
        self.writes = np.zeros((self.cols, self.rows), dtype=np.int64)
        self.loads, self.copies, self.stores = [], [], []
        self.ragged = False
        if tiling == "slab":
            self._slab(grid)
        else:
            self._tiles(grid)

    def _tile_at(self, t: int):
        row_blocks = -(-self.rows // self.t)
        r0, c0 = (t % row_blocks) * self.t, (t // row_blocks) * self.t
        return r0, c0, min(self.t, self.rows - r0), min(self.t,
                                                       self.cols - c0)

    def _fill(self, slot: np.ndarray, tile) -> tuple:
        """The bulk copies of ``fill``: row i of the tile, 4 cv bytes, into
        the slot at slot_row(t, i); returns the tile as the slot's tag."""
        r0, c0, rv, cv = tile
        src = self.x.view(np.uint8).reshape(self.rows, self.cols * 4)
        for i in range(rv):
            at = tb.slot_row(self.t, i)
            slot[at:at + 4 * cv] = src[r0 + i, 4 * c0:4 * (c0 + cv)]
            self.copies.append((4 * ((r0 + i) * self.cols + c0), 4 * cv))
        return tile

    def _drain(self, slot: np.ndarray, tile) -> None:
        """``drain``: lane (g, j) reads rows 4g .. 4g + 3 of chunk j and
        writes them as output rows c0 + 4j .. + 3 at columns r0 + 4g.  A
        block that crosses the tile's edge (rv or cv not a multiple of 4,
        a shape the route refuses) sets ``ragged``."""
        r0, c0, rv, cv = tile
        groups = self.t // 4
        lane = np.arange(32)
        for a in range(groups // 8):
            for b in range(groups // 4):
                g, j = (lane & 7) + 8 * a, (lane >> 3) + 4 * b
                live = (4 * g < rv) & (4 * j < cv)
                self.ragged |= bool(((4 * g + 4 > rv) & live).any() or
                                    ((4 * j + 4 > cv) & live).any())
                # at[n, p]: lane n's p-th 16-byte load
                at = np.array([[tb.slot_row(self.t, 4 * gg + p) + 16 * jj
                                for p in range(4)] for gg, jj in zip(g, j)])
                for p in range(4):
                    for q in range(4):   # a quarter-warp a phase
                        sel = slice(8 * q, 8 * q + 8)
                        self.loads.append(at[sel, p][live[sel]])
                block = slot[at[:, :, None] + np.arange(16)].view(np.int32)
                n = np.flatnonzero(live)
                for q in range(4):
                    orow = c0 + 4 * j[n] + q
                    self.stores.extend((4 * (orow * self.rows + r0 +
                                             4 * g[n])).tolist())
                    ocol = r0 + 4 * g[n][:, None] + np.arange(4)
                    keep = (orow[:, None] < self.cols) & (ocol < self.rows)
                    rr = np.broadcast_to(orow[:, None], ocol.shape)[keep]
                    self.out[rr, ocol[keep]] = block[n, :, q][keep]
                    np.add.at(self.writes, (rr, ocol[keep]), 1)

    def _tiles(self, grid: int) -> None:
        """``bulk_tile_kernel``: warp w of CTA b walks tiles b W + w + n G W
        through a ring of TILE_SLOTS slots, each refilled with the tile
        TILE_SLOTS steps on right after it is drained."""
        w_count, s_count = tb.TILE_WARPS, tb.TILE_SLOTS
        tiles = -(-self.rows // self.t) * -(-self.cols // self.t)
        step = grid * w_count
        for first in range(step):
            ring = [np.zeros(tb.slot_bytes(self.t), np.uint8)
                    for _ in range(s_count)]
            tags = [None] * s_count
            for s in range(s_count):
                if first + s * step < tiles:
                    tags[s] = self._fill(ring[s],
                                         self._tile_at(first + s * step))
            for n, t in enumerate(range(first, tiles, step)):
                s = n % s_count
                assert tags[s] == self._tile_at(t), (first, n)
                self._drain(ring[s], tags[s])
                if t + s_count * step < tiles:
                    tags[s] = self._fill(ring[s],
                                         self._tile_at(t + s_count * step))
                else:
                    tags[s] = None

    def _slab(self, grid: int) -> None:
        """``bulk_slab_kernel``: CTA b walks slabs b, b + G, ...; its warps
        own the chunks k = w, w + warps, ..., each in its own slot, drained
        and refilled with the same chunk of the CTA's next slab."""
        chunks = -(-self.cols // tb.CHUNK_WORDS)
        per_warp = -(-chunks // 32)
        warps = -(-chunks // per_warp)
        slabs = -(-self.rows // tb.SLAB_ROWS)

        def chunk_at(slab, k):
            r0, c0 = slab * tb.SLAB_ROWS, k * tb.CHUNK_WORDS
            return (r0, c0, min(tb.SLAB_ROWS, self.rows - r0),
                    min(tb.CHUNK_WORDS, self.cols - c0))

        for b in range(min(grid, slabs)):
            slots = [np.zeros(tb.slot_bytes(self.t), np.uint8)
                     for _ in range(chunks)]
            tags = [None] * chunks
            for w in range(warps):
                for k in range(w, chunks, warps):
                    tags[k] = self._fill(slots[k], chunk_at(b, k))
            for slab in range(b, slabs, grid):
                for w in range(warps):
                    for k in range(w, chunks, warps):
                        assert tags[k] == chunk_at(slab, k)
                        self._drain(slots[k], tags[k])
                        tags[k] = (self._fill(slots[k],
                                              chunk_at(slab + grid, k))
                                   if slab + grid < slabs else None)


def _input(shape, seed=26) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)


def _bulk_takes(walk: Walk, base: int) -> bool:
    """Whether every bulk copy (address and size) and every 16-byte store
    of the walk is 16-byte aligned, with the arrays at ``base``, and no 4 x
    4 block crosses a tile's edge: where the route's copies and stores can
    run."""
    return not walk.ragged and all(
        (base + a) % 16 == 0 and n % 16 == 0 for a, n in walk.copies) \
        and all((base + a) % 16 == 0 for a in walk.stores)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tiling", tb.TILINGS)
def test_bulk_walk_writes_each_word_once(tiling, shape):
    """Every output word written exactly once, with x.t()'s word, on grids
    of one CTA, a few, and more than the work; the route the model's
    alignment allows is the wrapper's."""
    x = _input(shape)
    xt = torch.from_numpy(x)
    route = tb.K26.route(tiling, xt)
    walk = Walk(tiling, x, 3)
    assert ("bulk" if _bulk_takes(walk, xt.data_ptr()) else "element") \
        == route
    if route != "bulk":
        return
    for grid in GRIDS if shape[0] * shape[1] < 50_000 else (SMS,):
        w = walk if grid == 3 else Walk(tiling, x, grid)
        assert (w.writes == 1).all(), grid
        assert np.array_equal(w.out, x.T.astype(np.int64)), grid


@pytest.mark.parametrize("tiling", tb.TILINGS)
def test_bulk_walk_shared_loads_conflict_free(tiling):
    """Each quarter-warp's 16-byte shared loads fall in distinct bank groups,
    in whole tiles and ragged edge tiles; the slot's rows do not overlap
    and end within the slot."""
    t = tb.TILE[tiling]
    walk = Walk(tiling, _input((t + 4 * (t // 8), 2 * t - 4)), 2)
    assert walk.loads
    for addrs in walk.loads:
        groups = bank_groups(addrs)
        assert len(set(groups.tolist())) == len(groups)
    ends = [tb.slot_row(t, i) + 4 * t for i in range(t)]
    assert all(tb.slot_row(t, i + 1) >= ends[i] for i in range(t - 1))
    assert ends[-1] <= tb.slot_bytes(t) and tb.slot_bytes(t) % 128 == 0


def test_bulk_route_refusals_and_misaligned_base():
    """A base off 16 bytes, or a pitch off 4 words, takes the element
    route; the JAX shape takes the bulk one, and every tiling's shared
    memory fits the card there (the slab's 33 chunk slots)."""
    buf = torch.zeros(96 * 80 + 1, dtype=torch.int32)
    off = buf[1:].view(96, 80)
    assert off.data_ptr() % 16 != 0
    for tiling in tb.TILINGS:
        assert tb.K26.route(tiling, off) == "element"
        assert tb.K26.route(tiling, torch.zeros((96, 82),
                                                dtype=torch.int32)) \
            == "element"
        assert tb.K26.route(tiling, torch.zeros((tb.B, tb.LW),
                                                dtype=torch.int32)) == "bulk"
    walk = Walk("32x32", off.numpy(), 2)
    assert not _bulk_takes(walk, off.data_ptr())
    budget = hardware.smem_budget_bytes()
    assert tb.slab_bytes("bulk", tb.LW) == 384 + 33 * 4224 <= budget
    for t in (32, 64):
        assert tb.BAR_BYTES + tb.TILE_WARPS * tb.TILE_SLOTS * \
            tb.slot_bytes(t) <= budget
    with pytest.raises(ValueError, match="does not fit"):
        tb.K26.route("slab", torch.zeros((4, 1800), dtype=torch.int32))
    assert tb.K26.route("slab", torch.zeros((3, 1800), dtype=torch.int32)) \
        == "element"


def test_wrapper_counts_no_launch_on_the_cpu():
    """On a CPU tensor each route's transpose is the plain version, and no
    launch of either route is counted."""
    before = (tb.K26.launches, dict(tb.K26.route_launches))
    for shape in ((96, 80), (33, 130)):
        x = torch.from_numpy(_input(shape))
        for tiling in tb.TILINGS:
            assert torch.equal(tb.K26.transpose(tiling, x), x.t())
    assert (tb.K26.launches, dict(tb.K26.route_launches)) == before
