"""Data module: datasets -> shuffled, padded, bucketed device batches.

Replaces the reference's Lightning TensorDataModule + PyG DataLoader
(data/datamodule.py:10-129, dataset/structure_scalar_tensor.py:421-666):
graphs are converted once (optionally cached), batches are padded to a
small ladder of bucket shapes so XLA compiles a bounded number of programs,
and `get_to_model_info()` provides the dataset -> model hand-off.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from matten_tpu.data.dataset import (
    DatasetStatistics,
    TensorDatasetConfig,
    load_tensor_dataset,
)
from matten_tpu.data import keys as K
from matten_tpu.data.graph import (
    CrystalGraph,
    PadSpec,
    attach_edge_vectors,
    collate_graphs,
)
from matten_tpu.nn.embedding import atomic_number_map

logger = logging.getLogger(__name__)

__all__ = ["TensorDataModule", "BatchLoader"]


class BatchLoader:
    """Yields (data, targets) numpy batches with bucketed static shapes."""

    def __init__(
        self,
        graphs: List[CrystalGraph],
        batch_size: int,
        species_map: np.ndarray,
        shuffle: bool = False,
        seed: int = 0,
        node_multiple: int = 32,
        edge_multiple: int = 512,
        drop_last: bool = False,
        num_shards: int = 1,
        num_edge_shards: int = 1,
        node_shard: bool = False,
        ring: bool = False,
        num_buckets: int = 4,
        batch_by_size: bool = False,
        precompute_edge_vectors: bool = True,
    ):
        """num_shards > 1 yields stacked per-shard batches [S, ...] for SPMD
        data parallelism (each shard is an independently padded sub-batch
        whose edge_index refers only to its own node block).

        num_edge_shards > 1 additionally splits each sub-batch's dst-sorted
        edge list into contiguous chunks [Sg, E/Sg, ...] for edge-partition
        parallelism over the mesh's 'graph' axis.

        num_buckets > 1 builds a small ladder of pad shapes sized from the
        batch-sum distribution (quantile levels, capped by the worst case);
        each batch is padded to the smallest bucket that fits, so
        heterogeneous datasets stop paying worst-case dummy-edge FLOPs on
        every batch while XLA compiles at most `num_buckets` programs per
        step function. Sharded layouts share one shape per stacked batch —
        the smallest level that fits every shard.

        batch_by_size composes batches from similarly-sized graphs
        (window-sorted bucketing: shuffle, sort within windows of
        4*batch_size, carve batches, shuffle the batch order — the
        torchtext/fairseq bucket-iterator pattern). Random batch sums are
        CLT-tight so a quantile ladder alone barely discriminates;
        size-sorted batches spread their sums across the ladder and each
        batch pads near its own content."""
        if batch_size % num_shards != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by {num_shards}")
        self.graphs = graphs
        self.batch_size = batch_size
        self.species_map = species_map
        self.shuffle = shuffle
        self.node_multiple = node_multiple
        self.edge_multiple = edge_multiple
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.num_edge_shards = num_edge_shards
        self.node_shard = node_shard
        self.ring = ring
        self.batch_by_size = batch_by_size
        if batch_by_size and len(graphs) <= 4 * batch_size:
            # single sort window -> the size sort fully determines batch
            # membership, identical every epoch. BatchNorm-based models then
            # memorize per-batch statistics: train loss keeps falling while
            # eval quality plateaus (measured on the n=100 elasticity set:
            # stuck at 5.5 GPa vs 0.5 GPa with random batches).
            logger.warning(
                "batch_by_size with a dataset that fits one sort window "
                "(%d graphs <= 4*batch_size=%d): batch membership becomes "
                "deterministic across epochs; models with batch "
                "normalization can overfit per-batch statistics and eval "
                "quality degrades. Use batch_by_size: false for small "
                "datasets.",
                len(graphs),
                4 * batch_size,
            )
        # False for force/stress-style consumers that differentiate w.r.t.
        # positions (see nn.edge_geometry.with_edge_vectors)
        self.precompute_edge_vectors = precompute_edge_vectors
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        # pin the per-node/per-graph classification of extra fields over the
        # WHOLE dataset (a per-batch shape heuristic misclassifies all-1-atom
        # batches, which batch_by_size makes likely)
        def _is_per_node(get):
            return all(
                np.asarray(get(g)).ndim >= 1
                and np.asarray(get(g)).shape[0] == g.num_nodes
                for g in graphs
            )

        pk = set()
        if graphs:
            for key in graphs[0].y:
                if _is_per_node(lambda g, k=key: g.y[k]):
                    pk.add(key)
            for key in graphs[0].x:
                if _is_per_node(lambda g, k=key: g.x[k]):
                    pk.add(key)
        self._per_node_keys = frozenset(pk)

        per_shard = batch_size // num_shards
        # ring slot-capacity ladder: (padded edges, Sg) -> running max cap2
        self._ring_cap2 = {}

        # worst-case bucket: the k largest graphs in one (sub-)batch
        sizes = np.sort(np.array([g.num_nodes for g in self.graphs]))[::-1]
        esizes = np.sort(np.array([g.num_edges for g in self.graphs]))[::-1]
        k = min(per_shard, len(graphs))
        n_max = int(sizes[:k].sum())
        e_max = int(esizes[:k].sum())
        self.pad = self._make_pad(n_max, e_max, per_shard)

        # bucket ladder: empirical quantiles of the (sub-)batch sum
        # distribution (bootstrap with a fixed rng so every epoch sees the
        # same ladder), worst case as the final level. Sharded layouts pick
        # one level per stacked batch (the smallest that fits every shard).
        self.pads = [self.pad]
        if num_buckets > 1 and 1 < k < len(graphs):
            arr_n = np.array([g.num_nodes for g in self.graphs])
            arr_e = np.array([g.num_edges for g in self.graphs])
            boot = np.random.default_rng(0xB0C)
            # simulate the EXACT iterator pipeline (shuffle [-> window sort]
            # -> carve batches -> strided shard split -> max over shards) so
            # the quantile levels match the sums _pick_pad_multi compares
            samp_n, samp_e = [], []
            rank_n, rank_e = {}, {}
            S = max(1, self.num_shards)
            for _ in range(128):
                order = boot.permutation(len(graphs))
                if batch_by_size:
                    order = self._size_order(order, arr_e)
                for r, j in enumerate(range(0, len(order), batch_size)):
                    b = order[j : j + batch_size]
                    lists = [b[s::S] for s in range(S) if len(b[s::S])]
                    bn = max(int(arr_n[l].sum()) for l in lists)
                    be = max(int(arr_e[l].sum()) for l in lists)
                    samp_n.append(bn)
                    samp_e.append(be)
                    rank_n[r] = max(rank_n.get(r, 0), bn)
                    rank_e[r] = max(rank_e.get(r, 0), be)
            if batch_by_size:
                # size-sorted batches have a stable RANK structure (batch 0
                # is always the heaviest of its window); a level at each
                # rank-band's simulated MAX fits every real batch of that
                # band snugly — distribution quantiles would sit at cluster
                # centers and overflow half of each cluster to the next level
                nranks = len(rank_n)
                nb = min(num_buckets, nranks)
                ladder = []
                for band in range(nb):
                    rs = [r for r in rank_n if r * nb // nranks == band]
                    ladder.append(
                        self._make_pad(
                            min(max(rank_n[r] for r in rs), n_max),
                            min(max(rank_e[r] for r in rs), e_max),
                            per_shard,
                        )
                    )
            else:
                # random batches: evenly spaced quantile levels + the
                # simulated max (q=1.0) + the worst case appended below
                qs = [(i + 1) / num_buckets for i in range(num_buckets)]
                ladder = [
                    self._make_pad(
                        min(int(np.quantile(samp_n, q)), n_max),
                        min(int(np.quantile(samp_e, q)), e_max),
                        per_shard,
                    )
                    for q in qs
                ]
            pads = sorted(
                set(ladder + [self.pad]), key=lambda p: (p.num_nodes, p.num_edges)
            )
            # keep only strictly growing shapes (dedup after rounding)
            self.pads = []
            for p in pads:
                if not self.pads or (
                    p.num_nodes > self.pads[-1].num_nodes
                    or p.num_edges > self.pads[-1].num_edges
                ):
                    self.pads.append(p)

    def _make_pad(self, n: int, e: int, per_shard: int) -> PadSpec:
        """Pad spec for raw totals (n nodes, e edges), honoring the rounding
        multiples; graph-sharded layouts split edges evenly over the shards."""
        n_pad = self._round(n + 1, self.node_multiple)
        e_pad = self._round(max(e, 1), self.edge_multiple)
        if self.num_edge_shards > 1:
            e_pad = self._round(e_pad, self.num_edge_shards)
        return PadSpec(n_pad, e_pad, per_shard)

    def _size_order(self, idx: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """Window-sorted ordering for batch_by_size (stable within windows
        of 4*batch_size, so shuffling still mixes window membership).
        Descending, so the ragged TAIL batch gets the window's smallest
        graphs instead of its largest."""
        w = 4 * self.batch_size
        parts = [
            idx[j : j + w][np.argsort(-sizes[idx[j : j + w]], kind="stable")]
            for j in range(0, len(idx), w)
        ]
        return np.concatenate(parts) if parts else idx

    def _pick_pad(self, graphs: List[CrystalGraph]) -> PadSpec:
        return self._pick_pad_ne(
            sum(g.num_nodes for g in graphs), sum(g.num_edges for g in graphs)
        )

    def _pick_pad_multi(self, shard_lists: List[List[CrystalGraph]]) -> PadSpec:
        """Smallest ladder level that fits EVERY shard of a stacked batch."""
        return self._pick_pad_ne(
            max(sum(g.num_nodes for g in gs) for gs in shard_lists),
            max(sum(g.num_edges for g in gs) for gs in shard_lists),
        )

    def _pick_pad_ne(self, n: int, e: int) -> PadSpec:
        for p in self.pads:
            if p.num_nodes > n and p.num_edges >= e:
                return p
        return self.pads[-1]

    @staticmethod
    def _round(n: int, m: int) -> int:
        return int(np.ceil(n / m)) * m

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling deterministically per epoch (the torch
        DistributedSampler convention), so a resumed run replays the same
        batch order the uninterrupted run would have drawn."""
        self._rng = np.random.default_rng(self.seed * 100_003 + epoch)

    def __len__(self) -> int:
        n = len(self.graphs)
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    NODE_FIELDS = (
        "pos", "atomic_numbers", "species_index", "num_neigh", "batch", "node_mask",
    )

    def _ring_order(self, graphs):
        """Size-balanced graph order for the ring layout: largest-first
        greedy assignment of graphs to the Sg node shards (by node count),
        emitted in shard order. Graph boundaries then track the contiguous
        node-chunk boundaries, so intra-graph edges concentrate on the
        diagonal (dst_owner == src_owner) ring slots and the worst slot
        stays near E/Sg — the actual-occupancy capacity in
        _shard_nodes_and_edges banks the reduction."""
        sg = self.num_edge_shards
        if len(graphs) <= 1 or sg <= 1:
            return graphs
        order = sorted(range(len(graphs)), key=lambda i: -graphs[i].num_nodes)
        bins = [[] for _ in range(sg)]
        loads = np.zeros(sg, dtype=np.int64)
        for i in order:
            b = int(np.argmin(loads))
            bins[b].append(graphs[i])
            loads[b] += graphs[i].num_nodes
        return [g for b in bins for g in b]

    def _ring_capacity(self, data: Dict) -> int:
        """Ring slot capacity for a collated (sub-)batch: the worst
        (dst_owner, src_owner) pair's actual occupancy (graphs are
        node-contiguous so diagonal pairs are dense; the size-balanced graph
        order from _ring_order keeps the max near E/Sg instead of the old
        conservative 2E/Sg), quantized and tracked as a running max per
        padded-edge bucket so shapes stabilize after the first epoch
        (rank-max ladder semantics)."""
        sg = self.num_edge_shards
        c = data["pos"].shape[0] // sg
        src, dst = data["edge_index"]
        real = data["edge_mask"]
        cnt = np.zeros((sg, sg), dtype=np.int64)
        np.add.at(cnt, (dst[real] // c, src[real] // c), 1)
        q = max(64, self.edge_multiple // sg)
        need = int(np.ceil(max(int(cnt.max()), 1) / q)) * q
        key = (data["edge_index"].shape[1], sg)
        cap2 = max(need, self._ring_cap2.get(key, 0))
        self._ring_cap2[key] = cap2
        return cap2

    def _shard_nodes_and_edges(self, data: Dict, targets: Optional[Dict] = None):
        """Node-sharded layout: nodes in Sg contiguous chunks; each edge
        lives with the shard owning its destination (src ids stay global,
        dst ids become local). Dummy fill edges get a huge cell shift so
        their radial window (and hence all message weights) is zero.

        ring=True additionally groups each shard's edges by SOURCE owner
        into Sg equal slots (group-major layout), the layout the
        ring-overlapped halo exchange consumes (nn/conv.py "node_ring")."""
        sg = self.num_edge_shards
        n = data["pos"].shape[0]
        assert n % sg == 0, f"padded nodes {n} not divisible by {sg}"
        c = n // sg
        data = dict(data)
        data.pop(K.EDGE_VECTORS, None)  # stale plain-layout vectors
        src, dst = data["edge_index"]
        real = data["edge_mask"]
        owner = dst // c
        if self.ring:
            src_owner = src // c
            cap2 = self._ring_capacity(data)
            # diagnostic for padding_report: (pre-ring padded edges, cap2)
            self._last_ring_stats = (data["edge_index"].shape[1], cap2)
            cap = sg * cap2
        else:
            cap = 2 * (data["edge_index"].shape[1] // sg)
        ei = np.zeros((sg, 2, cap), dtype=np.int32)
        shift = np.full((sg, cap, 3), 1e6, dtype=data["edge_cell_shift"].dtype)
        mask = np.zeros((sg, cap), dtype=bool)
        for s in range(sg):
            if self.ring:
                for so in range(sg):
                    sel = real & (owner == s) & (src_owner == so)
                    k = int(sel.sum())
                    assert k <= cap2, f"ring slot ({s},{so}) overflow ({k} > {cap2})"
                    o = so * cap2
                    ei[s, 0, o : o + k] = src[sel]
                    ei[s, 1, o : o + k] = dst[sel] - s * c
                    shift[s, o : o + k] = data["edge_cell_shift"][sel]
                    mask[s, o : o + k] = True
            else:
                sel = real & (owner == s)
                k = int(sel.sum())
                assert k <= cap, f"edge shard {s} overflow ({k} > {cap})"
                ei[s, 0, :k] = src[sel]
                ei[s, 1, :k] = dst[sel] - s * c
                shift[s, :k] = data["edge_cell_shift"][sel]
                mask[s, :k] = True
        data["edge_index"] = ei
        data["edge_cell_shift"] = shift
        data["edge_mask"] = mask
        for key in self.NODE_FIELDS:
            if key in data:
                v = data[key]
                data[key] = v.reshape((sg, c) + v.shape[1:])
        if targets is None:
            return data
        targets = dict(targets)
        for key, v in targets.items():
            if v.shape[0] == n:  # per-node targets shard with their nodes
                targets[key] = v.reshape((sg, c) + v.shape[1:])
        return data, targets

    def _shard_edges(self, data: Dict) -> Dict:
        """Split the dst-sorted edge arrays into contiguous chunks [Sg, ...]."""
        sg = self.num_edge_shards
        e = data["edge_index"].shape[1]
        assert e % sg == 0, f"padded edges {e} not divisible by {sg} shards"
        c = e // sg
        data = dict(data)
        data.pop(K.EDGE_VECTORS, None)  # stale plain-layout vectors
        data["edge_index"] = np.transpose(
            data["edge_index"].reshape(2, sg, c), (1, 0, 2)
        )
        data["edge_cell_shift"] = data["edge_cell_shift"].reshape(sg, c, 3)
        data["edge_mask"] = data["edge_mask"].reshape(sg, c)
        return data

    def __iter__(self) -> Iterator[Tuple[Dict, Dict]]:
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self._rng.shuffle(idx)
        order = np.arange(len(self))
        if self.batch_by_size:
            sizes = np.array([g.num_edges for g in self.graphs])
            idx = self._size_order(idx, sizes)
            if self.shuffle:
                self._rng.shuffle(order)
        for i in order:
            chunk = idx[i * self.batch_size : (i + 1) * self.batch_size]
            graphs = [self.graphs[j] for j in chunk]
            if self.num_shards == 1 and self.num_edge_shards == 1:
                yield collate_graphs(
                    graphs,
                    self._pick_pad(graphs),
                    species_map=self.species_map,
                    per_node_keys=self._per_node_keys,
                    precompute_edge_vectors=self.precompute_edge_vectors,
                )
                continue
            # strided shard assignment balances per-shard sums (with
            # batch_by_size the batch is a size gradient — contiguous
            # carving would give one shard all the big graphs and force
            # every shard onto its ladder level)
            raw_lists = [
                graphs[s :: self.num_shards] for s in range(self.num_shards)
            ]
            shard_lists = [gs or graphs[:1] for gs in raw_lists]
            if self.node_shard and self.ring:
                shard_lists = [self._ring_order(gs) for gs in shard_lists]
            pad = self._pick_pad_multi(shard_lists)
            collated = [
                collate_graphs(
                    gs,
                    pad,
                    species_map=self.species_map,
                    per_node_keys=self._per_node_keys,
                    precompute_edge_vectors=self.precompute_edge_vectors,
                )
                for gs in shard_lists
            ]
            if self.num_edge_shards > 1 and self.node_shard and self.ring:
                # one slot capacity for all shards of the stacked batch:
                # the running max over every shard, before any is laid out
                for d, _ in collated:
                    self._ring_capacity(d)
            shards = []
            for d, t in collated:
                if self.num_edge_shards > 1:
                    if self.node_shard:
                        d, t = self._shard_nodes_and_edges(d, t)
                    else:
                        d = self._shard_edges(d)
                    if self.precompute_edge_vectors:
                        # re-derive edge vectors for the final edge layout
                        attach_edge_vectors(d, dst_local=self.node_shard)
                shards.append((d, t))
            # ragged tail shards reuse graphs[:1] but zero the masks so they
            # contribute nothing
            data = {
                k: np.stack([s[0][k] for s in shards]) for k in shards[0][0]
            }
            targets = {
                k: np.stack([s[1][k] for s in shards]) for k in shards[0][1]
            }
            for s in range(self.num_shards):
                if not raw_lists[s]:
                    for key in ("node_mask", "edge_mask", "graph_mask"):
                        data[key][s] = False
                    # keep the attach_edge_vectors contract (`dummy edges
                    # get vec = 0`): the masks above are zeroed AFTER the
                    # vectors were computed, so the tail shard's vectors
                    # would otherwise stay nonzero (they are inert only
                    # because SH/radial are edge-masked downstream)
                    if K.EDGE_VECTORS in data:
                        data[K.EDGE_VECTORS][s] = 0.0
            yield data, targets


class TensorDataModule:
    """Train/val/test datasets + statistics + loaders."""

    def __init__(
        self,
        trainset_filename: str,
        valset_filename: str,
        testset_filename: str,
        *,
        r_cut: float,
        tensor_target_name: str = "elastic_tensor_full",
        tensor_target_format: str = "irreps",
        tensor_target_formula: str = "ijkl=jikl=klij",
        tensor_target_scale: float = 1.0,
        normalize_tensor_target: bool = False,
        tensor_target_weight: Optional[Dict] = None,
        atom_selector: Optional[str] = None,
        scalar_target_names: Optional[List[str]] = None,
        log_scalar_targets: Optional[List[bool]] = None,
        normalize_scalar_targets: Optional[List[bool]] = None,
        # precomputed feature columns in the data file (the working analog
        # of the reference's atom_featurizer/global_featurizer hand-off,
        # dataset/structure_scalar_tensor.py:502-552): a column name or
        # list of column names
        atom_featurizer: Optional[Any] = None,
        global_featurizer: Optional[Any] = None,
        normalize_atom_features: bool = False,
        normalize_global_features: bool = False,
        root: str = ".",
        reuse: bool = True,  # accepted for config compat; conversion is fast
        compute_dataset_statistics: bool = True,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        num_shards: int = 1,
    ):
        self.num_shards = num_shards

        def _cols(spec):
            if spec is None:
                return ()
            if isinstance(spec, str):
                return (spec,)
            return tuple(spec)

        self.cfg = TensorDatasetConfig(
            r_cut=r_cut,
            tensor_target_name=tensor_target_name,
            tensor_target_format=tensor_target_format,
            tensor_target_formula=tensor_target_formula,
            tensor_target_scale=tensor_target_scale,
            atom_selector=atom_selector,
            scalar_target_names=tuple(scalar_target_names or ()),
            log_scalar_targets=tuple(log_scalar_targets or ()),
            tensor_target_weight=tensor_target_weight,
            atom_feats_columns=_cols(atom_featurizer),
            global_feats_columns=_cols(global_featurizer),
        )
        self.normalize_atom_features = normalize_atom_features
        self.normalize_global_features = normalize_global_features
        self.root = Path(root)
        self.filenames = dict(
            train=trainset_filename, val=valset_filename, test=testset_filename
        )
        self.normalize_tensor_target = normalize_tensor_target
        self.normalize_scalar_targets = normalize_scalar_targets
        self.reuse = reuse
        self.compute_dataset_statistics = compute_dataset_statistics
        self.loader_kwargs = dict(loader_kwargs or {})
        self.seed = seed
        self.graphs: Dict[str, List[CrystalGraph]] = {}
        self.failed: Dict[str, List[int]] = {}
        self.statistics: Optional[DatasetStatistics] = None
        self.species_map: Optional[np.ndarray] = None

    def _cache_path(self, fname: str) -> Path:
        """Processed-graph cache (the reference's InMemoryDataset *_data.pt
        analog, data/dataset.py:123-152)."""
        import hashlib

        cfg = self.cfg
        key = hashlib.md5(
            f"{fname}|{cfg.r_cut}|{cfg.tensor_target_name}|{cfg.tensor_target_format}|"
            f"{cfg.tensor_target_formula}|{cfg.atom_selector}|{cfg.scalar_target_names}|"
            f"{cfg.log_scalar_targets}|{cfg.tensor_target_scale}|"
            f"{cfg.atom_feats_columns}|{cfg.global_feats_columns}".encode()
        ).hexdigest()[:12]
        return Path(self.root) / "processed" / f"{Path(fname).stem}_{key}.pkl"

    def setup(self) -> None:
        import pickle

        for split, fname in self.filenames.items():
            path = self.root / fname
            cache = self._cache_path(fname)
            if self.reuse and cache.exists():
                with open(cache, "rb") as f:
                    self.graphs[split], self.failed[split] = pickle.load(f)
                logger.info("%s: %d graphs (cached)", split, len(self.graphs[split]))
                continue
            self.graphs[split], self.failed[split] = load_tensor_dataset(path, self.cfg)
            try:
                cache.parent.mkdir(parents=True, exist_ok=True)
                with open(cache, "wb") as f:
                    pickle.dump((self.graphs[split], self.failed[split]), f)
            except OSError as e:  # read-only dataset roots: skip caching
                logger.debug("graph cache not written (%s)", e)
            logger.info(
                "%s: %d graphs (%d failed rows)",
                split,
                len(self.graphs[split]),
                len(self.failed[split]),
            )
        self.statistics = DatasetStatistics.compute(
            self.graphs["train"], self.cfg, self.normalize_tensor_target
        )
        self.species_map = atomic_number_map(self.statistics.allowed_species)
        if self.normalize_tensor_target:
            tn = self.statistics.target_normalizer
            for split in self.graphs:
                for g in self.graphs[split]:
                    name = self.cfg.tensor_target_name
                    g.y[name] = np.asarray(tn.forward(g.y[name]))
        for name, do in zip(
            self.cfg.scalar_target_names, self.normalize_scalar_targets or ()
        ):
            if not do:
                continue
            sn = self.statistics.scalar_normalizers[name]
            for split in self.graphs:
                for g in self.graphs[split]:
                    g.y[name] = np.asarray(sn.forward(np.atleast_2d(g.y[name])))
        # feature normalization (reference ScalarFeatureTransform applied as
        # pre_transform, data/transform.py:306-411; the reference forbids the
        # atom-feature case — supported here, train-set statistics)
        for name, do in (
            ("atom_feats", self.normalize_atom_features),
            ("global_feats", self.normalize_global_features),
        ):
            if not do:
                continue
            fn = self.statistics.feature_normalizers[name]
            for split in self.graphs:
                for g in self.graphs[split]:
                    g.x[name] = np.asarray(fn.forward(np.atleast_2d(g.x[name])))

    def get_to_model_info(self) -> Dict[str, Any]:
        """The dataset -> model hand-off (reference
        dataset/structure_scalar_tensor.py:640-666)."""

        def _size(name):
            g0 = self.graphs["train"][0]
            return int(np.atleast_2d(g0.x[name]).shape[-1]) if name in g0.x else None

        return {
            "allowed_species": list(self.statistics.allowed_species),
            "average_num_neighbors": self.statistics.average_num_neighbors,
            "global_feats_size": _size("global_feats"),
            "atom_feats_size": _size("atom_feats"),
        }

    # loader_kwargs keys forwarded verbatim to BatchLoader (the user surface
    # for bucketing); sharding keys come from set_sharding()
    _LOADER_PASSTHROUGH = (
        "node_multiple",
        "edge_multiple",
        "num_buckets",
        "drop_last",
        "batch_by_size",
        "precompute_edge_vectors",
    )

    def set_sharding(
        self,
        num_shards: int = 1,
        num_edge_shards: int = 1,
        node_shard: bool = False,
        ring: bool = False,
    ) -> None:
        """Configure the SPMD batch layout (mesh data/graph axes) for all
        loaders — the scripts wire this from trainer.devices/trainer.mesh
        (replacing the reference's Lightning num_nodes/devices knobs,
        scripts/configs/materials_tensor.yaml:73-76)."""
        self._shard_kwargs = dict(
            num_shards=num_shards,
            num_edge_shards=num_edge_shards,
            node_shard=node_shard,
            ring=ring,
        )

    def _loader(self, split: str, shuffle: bool) -> BatchLoader:
        bs = int(self.loader_kwargs.get("batch_size", 32))
        extra = {
            k: self.loader_kwargs[k]
            for k in self._LOADER_PASSTHROUGH
            if k in self.loader_kwargs
        }
        shard = getattr(self, "_shard_kwargs", None) or dict(num_shards=self.num_shards)
        return BatchLoader(
            self.graphs[split],
            batch_size=bs,
            species_map=self.species_map,
            shuffle=shuffle,
            seed=self.seed,
            **shard,
            **extra,
        )

    def train_dataloader(self) -> BatchLoader:
        return self._loader("train", shuffle=bool(self.loader_kwargs.get("shuffle", True)))

    def val_dataloader(self) -> BatchLoader:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> BatchLoader:
        return self._loader("test", shuffle=False)
