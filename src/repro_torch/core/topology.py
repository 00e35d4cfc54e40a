"""3D-mesh topology of the Network-on-Memory (port of
``repro.core.topology``, single stack).

The paper's evaluation target is an HMC-like stack: 4 DRAM layers, each an
8x8 grid of banks (two banks per slice, 32 slices) => an 8x8x4 mesh of 256
circuit-switched routers, one per bank.  Each router has six network ports
(+/-X, +/-Y, +/-Z) plus a local ejection/injection port into the bank.

A *vault* is a vertical column of banks sharing a TSV bus and a vault
controller on the logic die.  With 32 vaults over an 8x8 plane, one vault
spans a 1x2 column of (x, y) positions across all layers (8 banks/vault),
matching the HMC 2.1 organisation used by the paper.

Multi-stack topologies (``StackedTopology``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Port numbering. Dimension d, direction +1 -> port 2*d; direction -1 -> 2*d+1.
PORT_XP, PORT_XM, PORT_YP, PORT_YM, PORT_ZP, PORT_ZM, PORT_LOCAL = range(7)
N_PORTS = 7
_STEP = {PORT_XP: (1, 0, 0), PORT_XM: (-1, 0, 0),
         PORT_YP: (0, 1, 0), PORT_YM: (0, -1, 0),
         PORT_ZP: (0, 0, 1), PORT_ZM: (0, 0, -1)}


def port_for(dim: int, direction: int) -> int:
    """Output-port index for a hop along `dim` (0=x,1=y,2=z) in `direction` (+/-1)."""
    return 2 * dim + (1 if direction < 0 else 0)


@dataclasses.dataclass(frozen=True)
class Mesh3D:
    """An X x Y x Z mesh of NoM routers (paper default: 8 x 8 x 4)."""

    X: int = 8
    Y: int = 8
    Z: int = 4
    vault_span_y: int = 2  # a vault covers (1 x vault_span_y) columns of banks

    def __post_init__(self) -> None:
        if min(self.X, self.Y, self.Z) < 1:
            raise ValueError(f"mesh dims must be >= 1, got "
                             f"{(self.X, self.Y, self.Z)}")
        if self.vault_span_y < 1:
            raise ValueError(f"vault_span_y must be >= 1, got "
                             f"{self.vault_span_y}")
        if self.Y % self.vault_span_y:
            raise ValueError(f"Y={self.Y} is not divisible by "
                             f"vault_span_y={self.vault_span_y}: vaults would "
                             f"not tile the plane")

    @property
    def n_nodes(self) -> int:
        return self.X * self.Y * self.Z

    @property
    def n_vaults(self) -> int:
        return self.X * (self.Y // self.vault_span_y)

    @property
    def max_dist(self) -> int:
        return (self.X - 1) + (self.Y - 1) + (self.Z - 1)

    # --- id <-> coordinate ----------------------------------------------
    def node_id(self, x: int, y: int, z: int) -> int:
        return (z * self.Y + y) * self.X + x

    def coords(self, node: int) -> tuple[int, int, int]:
        x = node % self.X
        y = (node // self.X) % self.Y
        z = node // (self.X * self.Y)
        return x, y, z

    @cached_property
    def coord_array(self) -> np.ndarray:
        """(n_nodes, 3) int32 coordinates, row i = coords(i)."""
        ids = np.arange(self.n_nodes)
        return np.stack([ids % self.X, (ids // self.X) % self.Y,
                         ids // (self.X * self.Y)], axis=1).astype(np.int32)

    # --- adjacency --------------------------------------------------------
    def neighbor(self, node: int, port: int) -> int | None:
        """Node reached through `port`, or None at a mesh boundary."""
        if port == PORT_LOCAL:
            return None
        x, y, z = self.coords(node)
        dx, dy, dz = _STEP[port]
        nx, ny, nz = x + dx, y + dy, z + dz
        if 0 <= nx < self.X and 0 <= ny < self.Y and 0 <= nz < self.Z:
            return self.node_id(nx, ny, nz)
        return None

    def manhattan(self, a: int, b: int) -> int:
        ax, ay, az = self.coords(a)
        bx, by, bz = self.coords(b)
        return abs(ax - bx) + abs(ay - by) + abs(az - bz)

    def dor_path(self, src: int, dst: int) -> list[tuple[int, int]]:
        """Dimension-ordered (X then Y then Z) shortest path.

        Returns [(node, out_port), ...] for every hop; the last element's
        out_port is PORT_LOCAL (ejection at the destination).
        """
        path: list[tuple[int, int]] = []
        x, y, z = self.coords(src)
        dx_, dy_, dz_ = self.coords(dst)
        cur = src
        for dim, (c, t) in enumerate(((x, dx_), (y, dy_), (z, dz_))):
            step = 1 if t > c else -1
            for _ in range(abs(t - c)):
                p = port_for(dim, step)
                path.append((cur, p))
                cur = self.neighbor(cur, p)
        path.append((cur, PORT_LOCAL))
        if cur != dst:
            raise RuntimeError(f"dor_path ended at {cur}, not {dst}")
        return path

    # --- vaults (memory-controller domains) --------------------------------
    def vault_of(self, node: int) -> int:
        x, y, _z = self.coords(node)
        return x * (self.Y // self.vault_span_y) + y // self.vault_span_y

    def banks_of_vault(self, vault: int) -> list[int]:
        per_x = self.Y // self.vault_span_y
        x, yg = vault // per_x, vault % per_x
        return [self.node_id(x, yg * self.vault_span_y + dy, z)
                for z in range(self.Z) for dy in range(self.vault_span_y)]

    def column_of(self, node: int) -> int:
        """(x, y) column index — the NoM-Light vertical-bus resource id."""
        x, y, _z = self.coords(node)
        return y * self.X + x

    @cached_property
    def upstream_tables(self) -> dict[str, np.ndarray]:
        """Static gather tables: for each dimension d and direction s in
        {+1,-1}, ``prev[d][s]`` maps a node to the neighbour *against*
        travel direction (the upstream node when circuits travel along
        +s), with -1 at boundaries."""
        n = self.n_nodes
        prev = np.full((3, 2, n), -1, dtype=np.int32)
        for node in range(n):
            for dim in range(3):
                for si, s in enumerate((1, -1)):
                    nb = self.neighbor(node, port_for(dim, -s))
                    prev[dim, si, node] = -1 if nb is None else nb
        return {"prev": prev}


# Paper-default mesh (Section 3: 8x8x4, 256 banks, 32 vaults).
PAPER_MESH = Mesh3D(8, 8, 4)


def make_topology(n_stacks: int = 1,
                  mesh: Mesh3D | tuple[int, int, int] = PAPER_MESH,
                  *, vault_span_y: int = 2) -> Mesh3D:
    """The production constructor for NoM topologies (single stack).

    ``mesh`` may be a ``Mesh3D`` or an ``(X, Y, Z)`` tuple.  Stacked
    topologies (``n_stacks > 1``) are not ported yet and raise."""
    if n_stacks != 1:
        raise NotImplementedError(
            "multi-stack topologies (StackedTopology) are not ported to "
            "repro_torch yet; only n_stacks=1 is supported")
    if isinstance(mesh, tuple):
        mesh = Mesh3D(*mesh, vault_span_y=vault_span_y)
    return mesh
