"""Charged N-body dataset (config 1 of the evaluation ladder).

A copy of ``scalable_e3_gnn_tpu/data/nbody.py`` (numpy only), kept here so
the port imports nothing of the JAX package; the same seed gives the same
arrays bit for bit.  N charged particles with a softened Coulomb
interaction, integrated by leapfrog.  Task: from the initial positions,
velocities and charges, predict the displacement after ``num_steps`` steps
(an equivariant 1o target).  Graphs are fully connected.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["simulate_nbody", "generate_dataset", "make_fully_connected_edges"]


def simulate_nbody(
    rng: np.random.Generator,
    num_particles: int = 5,
    num_steps: int = 1000,
    dt: float = 1e-3,
    softening: float = 0.1,
    interaction: float = 1.0,
) -> Dict[str, np.ndarray]:
    """One trajectory.  Returns pos0, vel0, charges, pos_t (final positions)."""
    pos = rng.standard_normal((num_particles, 3))
    vel = 0.5 * rng.standard_normal((num_particles, 3))
    charges = rng.choice([-1.0, 1.0], size=(num_particles,))

    def forces(p):
        rel = p[None, :, :] - p[:, None, :]  # [i, j, 3] = x_j - x_i
        d2 = np.sum(rel * rel, axis=-1) + softening**2
        qq = charges[:, None] * charges[None, :]
        f = interaction * qq[..., None] * rel / d2[..., None] ** 1.5
        np.einsum("iic->ic", f)[:] = 0.0
        # like charges repel -> force on i is away from j when qq > 0
        return -np.sum(f, axis=1)

    # leapfrog
    acc = forces(pos)
    p, v = pos.copy(), vel.copy()
    for _ in range(num_steps):
        v_half = v + 0.5 * dt * acc
        p = p + dt * v_half
        acc = forces(p)
        v = v_half + 0.5 * dt * acc
    return {"pos0": pos, "vel0": vel, "charges": charges, "pos_t": p}


def generate_dataset(
    num_graphs: int,
    num_particles: int = 5,
    num_steps: int = 1000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Stacked trajectories: pos0/vel0 [G,N,3], charges [G,N], target disp [G,N,3]."""
    rng = np.random.default_rng(seed)
    trajs = [
        simulate_nbody(rng, num_particles=num_particles, num_steps=num_steps)
        for _ in range(num_graphs)
    ]
    return {
        "pos0": np.stack([t["pos0"] for t in trajs]).astype(np.float32),
        "vel0": np.stack([t["vel0"] for t in trajs]).astype(np.float32),
        "charges": np.stack([t["charges"] for t in trajs]).astype(np.float32),
        "disp": np.stack([t["pos_t"] - t["pos0"] for t in trajs]).astype(np.float32),
    }


def make_fully_connected_edges(num_particles: int) -> Tuple[np.ndarray, np.ndarray]:
    """Directed complete graph without self-loops, sorted by receiver."""
    s, r = [], []
    for recv in range(num_particles):
        for send in range(num_particles):
            if send != recv:
                s.append(send)
                r.append(recv)
    return np.asarray(s, np.int32), np.asarray(r, np.int32)
