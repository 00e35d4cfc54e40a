"""3D-mesh topology of the Network-on-Memory (port of
``repro.core.topology``).

The paper's evaluation target is an HMC-like stack: 4 DRAM layers, each an
8x8 grid of banks (two banks per slice, 32 slices) => an 8x8x4 mesh of 256
circuit-switched routers, one per bank.  Each router has six network ports
(+/-X, +/-Y, +/-Z) plus a local ejection/injection port into the bank.

A *vault* is a vertical column of banks sharing a TSV bus and a vault
controller on the logic die.  With 32 vaults over an 8x8 plane, one vault
spans a 1x2 column of (x, y) positions across all layers (8 banks/vault),
matching the HMC 2.1 organisation used by the paper.
"""
from __future__ import annotations

import bisect
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


@dataclasses.dataclass(frozen=True)
class StackLink:
    """One inter-stack SerDes link between stacks ``a`` and ``b``.

    A link is a point-to-point serial lane pair, so it carries two
    *directed channels* (a->b and b->a) that are reserved independently.
    Its timing is a different class from mesh-hop TSV timing: a beat takes
    ``latency`` extra cycles to cross (flight + SerDes retiming), and one
    TDM slot-window moves ``link_bytes`` bytes (typically narrower than
    the 8-byte intra-stack mesh link).
    """

    a: int
    b: int
    latency: int = 8
    link_bytes: int = 4


@dataclasses.dataclass(frozen=True)
class StackedTopology:
    """N ``Mesh3D`` stacks chained by an inter-stack SerDes link graph.

    Two-level addressing: a bank is named by ``(stack, local node)`` or by
    a flat *global id* (``global_id``/``locate`` convert).  Each stack
    keeps its own slot tables and CCU; traffic between stacks leaves
    through the stack's *bridge bank* — the ``(0, 0, 0)`` logic-die
    landing node — crosses one or more SerDes links, and re-enters the
    destination stack's mesh at its bridge.

    ``link`` picks the inter-stack graph: ``"ring"`` (each stack wired to
    its two neighbours, shortest-direction routing) or ``"full"`` (a
    dedicated link per stack pair).  Heterogeneous stacks are allowed via
    ``meshes``; by default all stacks share ``mesh``.
    """

    n_stacks: int
    mesh: Mesh3D = PAPER_MESH
    link: str = "ring"
    link_latency: int = 8
    link_bytes: int = 4
    meshes: tuple[Mesh3D, ...] | None = None

    def __post_init__(self) -> None:
        if self.n_stacks < 1:
            raise ValueError(f"n_stacks must be >= 1, got {self.n_stacks}")
        if self.link not in ("ring", "full"):
            raise ValueError(f"unknown link topology {self.link!r}; "
                             f"expected 'ring' or 'full'")
        if self.link_latency < 0 or self.link_bytes < 1:
            raise ValueError("link_latency must be >= 0 and link_bytes >= 1")
        if self.meshes is not None:
            object.__setattr__(self, "meshes", tuple(self.meshes))
            if len(self.meshes) != self.n_stacks:
                raise ValueError(f"meshes has {len(self.meshes)} entries for "
                                 f"n_stacks={self.n_stacks}")

    @cached_property
    def stacks(self) -> tuple[Mesh3D, ...]:
        """Per-stack meshes (``meshes`` if given, else ``mesh`` repeated)."""
        return self.meshes if self.meshes else (self.mesh,) * self.n_stacks

    @cached_property
    def offsets(self) -> tuple[int, ...]:
        """Global-id base of each stack (stack s owns offsets[s] .. +n_nodes)."""
        out, acc = [], 0
        for m in self.stacks:
            out.append(acc)
            acc += m.n_nodes
        return tuple(out)

    @property
    def n_nodes(self) -> int:
        return self.offsets[-1] + self.stacks[-1].n_nodes

    # --- two-level addressing ------------------------------------------------
    def global_id(self, stack: int, node: int) -> int:
        """Flat bank id of local ``node`` in ``stack``."""
        if not 0 <= stack < self.n_stacks:
            raise ValueError(f"stack {stack} out of range [0, {self.n_stacks})")
        if not 0 <= node < self.stacks[stack].n_nodes:
            raise ValueError(f"node {node} out of range for stack {stack}")
        return self.offsets[stack] + node

    def locate(self, gid: int) -> tuple[int, int]:
        """Inverse of ``global_id``: flat id -> ``(stack, local node)``."""
        if not 0 <= gid < self.n_nodes:
            raise ValueError(f"global id {gid} out of range [0, {self.n_nodes})")
        stack = bisect.bisect_right(self.offsets, gid) - 1
        return stack, gid - self.offsets[stack]

    def stack_of(self, gid: int) -> int:
        """Stack owning flat bank id ``gid``."""
        return self.locate(gid)[0]

    def bridge_of(self, stack: int) -> int:
        """Local id of the stack's bridge bank — the (0, 0, 0) logic-die
        landing node where SerDes traffic enters/leaves the mesh."""
        if not 0 <= stack < self.n_stacks:
            raise ValueError(f"stack {stack} out of range [0, {self.n_stacks})")
        return self.stacks[stack].node_id(0, 0, 0)

    def is_cross(self, a: int, b: int) -> bool:
        """True when flat ids ``a`` and ``b`` live in different stacks."""
        return self.stack_of(a) != self.stack_of(b)

    # --- the link graph ------------------------------------------------------
    @cached_property
    def links(self) -> tuple[StackLink, ...]:
        n = self.n_stacks
        if n == 1:
            return ()
        if self.link == "full" or n == 2:
            pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
        else:  # ring
            pairs = [(i, (i + 1) % n) for i in range(n)]
        return tuple(StackLink(a, b, self.link_latency, self.link_bytes)
                     for a, b in pairs)

    @property
    def n_channels(self) -> int:
        """Directed SerDes channels: two (one per direction) per link."""
        return 2 * len(self.links)

    @cached_property
    def _chan(self) -> dict[tuple[int, int], int]:
        out: dict[tuple[int, int], int] = {}
        for k, ln in enumerate(self.links):
            out[(ln.a, ln.b)] = 2 * k
            out[(ln.b, ln.a)] = 2 * k + 1
        return out

    def channel(self, a: int, b: int) -> int:
        """Directed channel id for the ``a -> b`` SerDes hop (adjacent stacks)."""
        try:
            return self._chan[(a, b)]
        except KeyError:
            raise ValueError(f"stacks {a} and {b} are not directly linked "
                             f"under {self.link!r}") from None

    def stack_route(self, src_stack: int, dst_stack: int) -> list[tuple[int, int]]:
        """Directed stack hops ``[(a, b), ...]`` from src to dst stack.

        Empty for same-stack; one hop under ``"full"``; shortest ring
        direction (ties broken towards +1) under ``"ring"``.
        """
        for s in (src_stack, dst_stack):
            if not 0 <= s < self.n_stacks:
                raise ValueError(f"stack {s} out of range [0, {self.n_stacks})")
        if src_stack == dst_stack:
            return []
        if self.link == "full" or self.n_stacks == 2:
            return [(src_stack, dst_stack)]
        n = self.n_stacks
        fwd = (dst_stack - src_stack) % n
        step = 1 if fwd <= (src_stack - dst_stack) % n else -1
        hops, cur = [], src_stack
        while cur != dst_stack:
            nxt = (cur + step) % n
            hops.append((cur, nxt))
            cur = nxt
        return hops

    def route_channels(self, src_stack: int, dst_stack: int) -> list[int]:
        """Directed channel ids along ``stack_route(src_stack, dst_stack)``."""
        return [self.channel(a, b)
                for a, b in self.stack_route(src_stack, dst_stack)]

    def route_cycles(self, src_stack: int, dst_stack: int) -> int:
        """Beat latency of the SerDes leg: each hop costs 1 (slot advance)
        + the link's SerDes latency."""
        return sum(1 + self.links[c // 2].latency
                   for c in self.route_channels(src_stack, dst_stack))


def make_topology(n_stacks: int = 1,
                  mesh: Mesh3D | tuple[int, int, int] = PAPER_MESH,
                  *, link: str = "ring", link_latency: int = 8,
                  link_bytes: int = 4, vault_span_y: int = 2,
                  meshes=None) -> Mesh3D | StackedTopology:
    """The one production constructor for NoM topologies.

    Returns the bare ``Mesh3D`` for ``n_stacks=1`` (so every single-stack
    call site keeps today's exact types and behavior) and a
    ``StackedTopology`` otherwise.  ``mesh`` (or each entry of ``meshes``)
    may be a ``Mesh3D`` or an ``(X, Y, Z)`` tuple.  Production code must
    build topologies here rather than calling ``Mesh3D(...)`` directly —
    enforced by ``scripts/check_api.py``.
    """
    if isinstance(mesh, tuple):
        mesh = Mesh3D(*mesh, vault_span_y=vault_span_y)
    if meshes is not None:
        meshes = tuple(Mesh3D(*m, vault_span_y=vault_span_y)
                       if isinstance(m, tuple) else m for m in meshes)
        n_stacks = len(meshes)
    if n_stacks == 1 and meshes is None:
        return mesh
    return StackedTopology(n_stacks, mesh, link=link,
                           link_latency=link_latency, link_bytes=link_bytes,
                           meshes=meshes)
