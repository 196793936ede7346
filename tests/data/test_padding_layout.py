"""Collation pads only to the node/edge multiples and the bucket ladder:
every real edge survives, each batch takes the smallest ladder level that
fits it, and no kernel-layout fields are emitted."""

import numpy as np
import pytest

from matten_tpu.data import keys as K
from matten_tpu.data.datamodule import BatchLoader
from matten_tpu.data.graph import CrystalGraph, PadSpec, collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure

FIELDS = {
    K.POSITIONS, K.ATOMIC_NUMBERS, K.NUM_NEIGH, K.BATCH, K.NODE_MASK,
    K.EDGE_INDEX, K.EDGE_CELL_SHIFT, K.EDGE_MASK, K.CELL, K.GRAPH_MASK,
    K.SPECIES_INDEX, K.EDGE_VECTORS,
}


def _graphs(n, seed=0, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        s = Structure(
            np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
            rng.uniform(0, 1, (k, 3)),
            rng.choice([8, 14, 22], k),
        )
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        out.append(g)
    return out


def _edge_multiset(ei, shift, mask):
    ei = np.asarray(ei).reshape(-1, 2, ei.shape[-1]) if ei.ndim == 3 else ei[None]
    rows = []
    for s in range(ei.shape[0]):
        m = np.asarray(mask).reshape(ei.shape[0], -1)[s]
        sh = np.asarray(shift).reshape(ei.shape[0], -1, 3)[s]
        rows += [
            (int(a), int(b), *np.round(c, 6)) for a, b, c in zip(ei[s, 0][m], ei[s, 1][m], sh[m])
        ]
    return sorted(rows)


def test_collation_keeps_every_edge_and_emits_no_layout_fields():
    graphs = _graphs(12)
    pad = pad_spec_for(graphs)
    data, _ = collate_graphs(graphs, pad, species_map=np.arange(64, dtype=np.int32))
    assert set(data) == FIELDS
    want, off = [], 0
    for g in graphs:
        want += [
            (int(a) + off, int(b) + off, *np.round(c, 6))
            for a, b, c in zip(g.edge_index[0], g.edge_index[1], g.edge_cell_shift)
        ]
        off += g.num_nodes
    got = _edge_multiset(data[K.EDGE_INDEX], data[K.EDGE_CELL_SHIFT], data[K.EDGE_MASK])
    assert got == sorted(want)
    # dst-sorted, dummy edges self-loops on the last (masked) node
    dst = data[K.EDGE_INDEX][1]
    assert np.all(np.diff(dst) >= 0)
    assert np.all(data[K.EDGE_INDEX][:, ~data[K.EDGE_MASK]] == pad.num_nodes - 1)


def test_pad_spec_is_plain_rounding():
    graphs = _graphs(5)
    n = sum(g.num_nodes for g in graphs)
    e = sum(g.num_edges for g in graphs)
    pad = pad_spec_for(graphs, node_multiple=16, edge_multiple=128, graph_multiple=4)
    assert pad == PadSpec(
        int(np.ceil((n + 1) / 16)) * 16, int(np.ceil((e + 1) / 128)) * 128, 8
    )


def test_ladder_picks_smallest_fitting_level_and_drops_no_edge():
    graphs = _graphs(96, seed=1, lo=2, hi=16)
    loader = BatchLoader(
        graphs, batch_size=8, species_map=np.arange(64, dtype=np.int32),
        shuffle=True, node_multiple=16, edge_multiple=128, num_buckets=4,
    )
    assert len(loader.pads) > 1
    for p in loader.pads:
        assert p.num_nodes % 16 == 0 and p.num_edges % 128 == 0
    real = 0
    for data, _ in loader:
        n = int(data[K.NODE_MASK].sum())
        e = int(data[K.EDGE_MASK].sum())
        real += e
        fits = [p for p in loader.pads if p.num_nodes > n and p.num_edges >= e]
        assert (data[K.POSITIONS].shape[0], data[K.EDGE_MASK].shape[0]) == (
            fits[0].num_nodes, fits[0].num_edges
        )
    assert real == sum(g.num_edges for g in graphs)


@pytest.mark.parametrize(
    "layout",
    [
        dict(num_shards=2),
        dict(num_shards=1, num_edge_shards=2),
        dict(num_shards=1, num_edge_shards=2, node_shard=True),
        dict(num_shards=1, num_edge_shards=2, node_shard=True, ring=True),
    ],
    ids=["data", "edge", "node", "node_ring"],
)
def test_sharded_layouts_drop_no_edge(layout):
    graphs = _graphs(16, seed=2)
    loader = BatchLoader(
        graphs, batch_size=8, species_map=np.arange(64, dtype=np.int32),
        node_multiple=16, edge_multiple=128, **layout,
    )
    real = 0
    for data, _ in loader:
        assert set(data) == FIELDS
        assert data[K.EDGE_MASK].shape[-1] % layout.get("num_edge_shards", 1) == 0
        real += int(data[K.EDGE_MASK].sum())
    assert real == sum(g.num_edges for g in graphs)
