"""Canonical field names of the graph data dict.

The framework's universal data representation is a flat
``{field_name: jnp.ndarray}`` dict (a JAX pytree), mirroring the reference's
DataKey registry (data/_key.py:14-49) with additional static-shape padding
masks.
"""

# --- geometry ---------------------------------------------------------------
POSITIONS = "pos"  # [N, 3] cartesian coordinates
EDGE_INDEX = "edge_index"  # [2, E] int32; row 0 = source/center, row 1 = target
EDGE_CELL_SHIFT = "edge_cell_shift"  # [E, 3] periodic image shifts (float)
CELL = "cell"  # [G, 3, 3] lattice vectors as rows (ASE convention)
NUM_NEIGH = "num_neigh"  # [N] float neighbor counts
BATCH = "batch"  # [N] int32 graph id of each node

# --- species ----------------------------------------------------------------
ATOMIC_NUMBERS = "atomic_numbers"  # [N] int32
SPECIES_INDEX = "species_index"  # [N] int32, 0..num_species-1

# --- learned fields ---------------------------------------------------------
NODE_FEATURES = "node_features"
NODE_ATTRS = "node_attrs"
EDGE_ATTRS = "edge_attrs"
EDGE_EMBEDDING = "edge_embedding"
EDGE_VECTORS = "edge_vectors"
EDGE_LENGTH = "edge_length"
ATOM_FEATS = "atom_feats"  # [N, F] precomputed per-atom features
GLOBAL_FEATS = "global_feats"  # [G, F] precomputed per-crystal features

POS_FULL = "pos_full"  # [N_total, 3] halo-gathered positions (node-sharded mode)

# --- padding masks (static shapes; no reference counterpart) ----------------
NODE_MASK = "node_mask"  # [N] bool, True = real node
EDGE_MASK = "edge_mask"  # [E] bool, True = real edge
GRAPH_MASK = "graph_mask"  # [G] bool, True = real graph

# --- misc -------------------------------------------------------------------
ATOM_SELECTOR = "atom_selector"  # [N] bool mask for per-atom targets
