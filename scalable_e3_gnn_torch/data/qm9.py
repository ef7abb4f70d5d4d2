"""QM9-style molecular graphs: variable-size padded batching (config 2).

A copy of ``scalable_e3_gnn_tpu/data/qm9.py`` (numpy), kept here so the port
imports nothing of the JAX package; the same seed gives the same molecules
and batch arrays bit for bit, and ``batch_molecules`` returns them as
tensors on the requested device.  ``load_qm9`` parses real dsgdb9nsd .xyz
records (the ``*^`` Fortran-notation floats included; ``tests/fixtures/qm9``
holds three); nothing is downloaded.  ``generate_molecules`` is the
synthetic stand-in with the same interface: 3..29 atoms, 5 species (H C N
O F one-hot), conformer-like geometry, and a smooth rotation-invariant
scalar target (a function of the pairwise-distance spectrum).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "generate_molecules", "batch_molecules", "load_qm9", "NUM_SPECIES",
    "split_qm9", "load_uncharacterized", "target_unit", "QM9_SPLIT",
    "HARTREE_TO_MEV",
]

NUM_SPECIES = 5
_COV_RADII = np.array([0.32, 0.75, 0.71, 0.63, 0.64])  # H C N O F (Å-ish)

_SPECIES_OF = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}
# gdb9 line-2 token index per property (after 'gdb_<idx>'): SI of
# Ramakrishnan et al. 2014 — A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv
_QM9_PROPS = {
    "A": 2, "B": 3, "C": 4, "mu": 5, "alpha": 6, "homo": 7, "lumo": 8,
    "gap": 9, "r2": 10, "zpve": 11, "U0": 12, "U": 13, "H": 14, "G": 15,
    "Cv": 16,
}

HARTREE_TO_MEV = 27211.386245988  # 1 Ha in meV (CODATA 2018)

# reporting convention (SEGNN / SchNet / DimeNet literature): energetic
# targets in meV, everything else in the raw gdb9 unit.  (factor, unit) maps
# the file's native unit -> the reported unit; MAEs multiply by factor.
_QM9_REPORT = {
    "A": (1.0, "GHz"), "B": (1.0, "GHz"), "C": (1.0, "GHz"),
    "mu": (1.0, "D"), "alpha": (1.0, "a0^3"),
    "homo": (HARTREE_TO_MEV, "meV"), "lumo": (HARTREE_TO_MEV, "meV"),
    "gap": (HARTREE_TO_MEV, "meV"), "r2": (1.0, "a0^2"),
    "zpve": (HARTREE_TO_MEV, "meV"), "U0": (HARTREE_TO_MEV, "meV"),
    "U": (HARTREE_TO_MEV, "meV"), "H": (HARTREE_TO_MEV, "meV"),
    "G": (HARTREE_TO_MEV, "meV"), "Cv": (1.0, "cal/(mol K)"),
}

# canonical literature split (Brandstetter et al. 2022 / NequIP convention):
# random permutation at a fixed seed over the ~130,831 characterized
# molecules -> 110,000 train / 10,000 val / remainder (~10,831) test
QM9_SPLIT = {"train": 110_000, "val": 10_000}


def target_unit(target: str):
    """(conversion factor from raw file unit, reported unit) for a target."""
    return _QM9_REPORT[target]


def load_uncharacterized(path: str) -> set:
    """gdb indices of the 3,054 uncharacterized molecules to exclude.

    Parses QM9's ``uncharacterized.txt`` companion file if present under
    ``path`` (lines whose first token is an integer index; header/footer
    lines are skipped).  Returns an empty set when the file is absent —
    callers then train on the full download, which is also a published
    variant of the protocol."""
    import os

    fn = os.path.join(path, "uncharacterized.txt")
    if not os.path.isfile(fn):
        return set()
    out = set()
    with open(fn) as fh:
        for ln in fh:
            tok = ln.split()
            if tok and tok[0].isdigit():
                out.add(int(tok[0]))
    return out


def split_qm9(molecules: List[dict], seed: int = 0):
    """Deterministic literature split: shuffle once at ``seed``, then
    110k/10k/rest.  When fewer molecules are supplied (CI fixtures,
    ``limit=``), the split scales proportionally (83.9% / 7.6% / rest,
    min 1 molecule per split) so the protocol path is identical.

    Returns ``(train, val, test)`` lists of molecule dicts."""
    n = len(molecules)
    order = np.random.default_rng(seed).permutation(n)
    full = QM9_SPLIT["train"] + QM9_SPLIT["val"] + 10_831
    if n >= full:
        n_tr, n_va = QM9_SPLIT["train"], QM9_SPLIT["val"]
    else:
        n_tr = max(int(n * QM9_SPLIT["train"] / full), 1)
        n_va = max(int(n * QM9_SPLIT["val"] / full), 1)
        assert n_tr + n_va < n, f"need >= {n_tr + n_va + 1} molecules, got {n}"
    tr = [molecules[i] for i in order[:n_tr]]
    va = [molecules[i] for i in order[n_tr : n_tr + n_va]]
    te = [molecules[i] for i in order[n_tr + n_va :]]
    return tr, va, te


def _parse_qm9_xyz(text: str, target: str) -> dict:
    """One dsgdb9nsd .xyz record -> molecule dict (positions in Å).

    Format: line 1 = natoms; line 2 = 'gdb <idx> <17 scalar properties>';
    then natoms lines '<symbol> <x> <y> <z> <mulliken>'.  Floats may use
    Fortran D-notation (1.234*^-5 / 1.234D-5 in some mirrors)."""
    f = lambda s: float(s.replace("*^", "e").replace("D", "e").replace("d", "e"))
    lines = text.strip().splitlines()
    n = int(lines[0].split()[0])
    props = lines[1].split()
    tgt = f(props[_QM9_PROPS[target]])
    species = np.zeros((n,), np.int64)
    pos = np.zeros((n, 3), np.float32)
    for i, ln in enumerate(lines[2 : 2 + n]):
        tok = ln.split()
        species[i] = _SPECIES_OF[tok[0]]
        pos[i] = [f(tok[1]), f(tok[2]), f(tok[3])]
    return {"species": species, "positions": pos, "target": float(tgt),
            "index": int(props[1])}


def load_qm9(
    path: str,
    target: str = "U0",
    max_atoms: int = 29,
    limit: int | None = None,
    exclude: set | None = None,
) -> List[dict]:
    """Load real QM9 molecules from a directory of dsgdb9nsd .xyz files (or
    a single multi-record source isn't supported — QM9 ships one file per
    molecule).  Returns the same molecule-dict list as
    ``generate_molecules``, so ``batch_molecules`` / ``run_qm9`` work
    unchanged.  Nothing is downloaded: callers point ``path`` at an
    existing download, and a clear error is raised otherwise.
    """
    import glob
    import os

    if target not in _QM9_PROPS:
        raise ValueError(f"unknown QM9 target {target!r}; one of {sorted(_QM9_PROPS)}")
    files = sorted(glob.glob(os.path.join(path, "*.xyz")))
    if not files:
        raise FileNotFoundError(
            f"no .xyz files under {path!r} — download QM9 (dsgdb9nsd) there, "
            "or use generate_molecules() for the synthetic stand-in"
        )
    if limit is not None:
        files = files[:limit]
    mols = []
    exclude = exclude or set()
    for fn in files:
        with open(fn) as fh:
            m = _parse_qm9_xyz(fh.read(), target)
        if m["index"] in exclude:  # uncharacterized (load_uncharacterized)
            continue
        if len(m["species"]) <= max_atoms:
            mols.append(m)
    return mols


def _random_molecule(rng: np.random.Generator, min_atoms=3, max_atoms=29):
    n = int(rng.integers(min_atoms, max_atoms + 1))
    species = rng.integers(0, NUM_SPECIES, n)
    # grow a loose cluster: each atom near a previous one (molecule-like)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        j = int(rng.integers(0, i))
        d = _COV_RADII[species[i]] + _COV_RADII[species[j]] + 0.3 * rng.random()
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        pos[i] = pos[j] + d * u
    pos -= pos.mean(0)
    # invariant target: smooth function of the distance spectrum + composition
    dmat = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    target = float(
        np.exp(-dmat[dmat > 0]).sum() / n + 0.1 * np.bincount(species, minlength=5) @ np.arange(1, 6) / n
    )
    return {"species": species, "positions": pos.astype(np.float32), "target": target}


def generate_molecules(num: int, seed: int = 0, max_atoms: int = 29) -> List[dict]:
    rng = np.random.default_rng(seed)
    return [_random_molecule(rng, max_atoms=max_atoms) for _ in range(num)]


def batch_molecules(
    molecules: List[dict],
    nodes_per_graph: int = 29,
    radius: float = 2.0,
    max_neighbors: int = 16,
    device=None,
):
    """Pad each molecule to ``nodes_per_graph`` and build intra-molecule radius
    edges (exact brute force per molecule — molecules are tiny).

    Returns a SteerableGraph on ``device`` (the GPU unless given; one flat
    address space, receiver-sorted edges, padding edges masked with sender
    N) and targets [G]; node features are the species one-hot [N,
    NUM_SPECIES], 0 rows on padding.
    """
    import torch

    from ..graph.container import SteerableGraph
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    G = len(molecules)
    Np = nodes_per_graph
    K = max_neighbors
    feats = np.zeros((G * Np, NUM_SPECIES), np.float32)
    pos = np.zeros((G * Np, 3), np.float32)
    node_mask = np.zeros((G * Np,), bool)
    node_graph = np.full((G * Np,), G, np.int32)
    senders_all, receivers_all, mask_all = [], [], []
    for g, mol in enumerate(molecules):
        n = len(mol["species"])
        base = g * Np
        feats[base : base + n] = np.eye(NUM_SPECIES, dtype=np.float32)[mol["species"]]
        pos[base : base + n] = mol["positions"]
        node_mask[base : base + n] = True
        node_graph[base : base + n] = g
        d = np.linalg.norm(
            mol["positions"][:, None] - mol["positions"][None, :], axis=-1
        )
        for i in range(Np):
            if i < n:
                nb = np.where((d[i] <= radius) & (np.arange(n) != i))[0]
                nb = nb[np.argsort(d[i][nb])][:K]
            else:
                nb = np.zeros((0,), np.int64)
            k = len(nb)
            senders_all.append(base + nb)
            senders_all.append(np.full((K - k,), G * Np, np.int64))
            receivers_all.append(np.full((k,), base + i, np.int64))
            receivers_all.append(np.full((K - k,), base + i, np.int64))
            mask_all.append(np.ones((k,), bool))
            mask_all.append(np.zeros((K - k,), bool))
    senders = np.concatenate(senders_all).astype(np.int32)
    receivers = np.concatenate(receivers_all).astype(np.int32)
    mask = np.concatenate(mask_all)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    graph = SteerableGraph(
        nodes=t(feats),
        positions=t(pos),
        senders=t(senders),
        receivers=t(receivers),
        node_graph=t(node_graph),
        node_mask=t(node_mask),
        edge_mask=t(mask),
        n_graphs=G,
    )
    targets = np.asarray([m["target"] for m in molecules], np.float32)
    return graph, t(targets)
