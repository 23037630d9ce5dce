"""Acyclicity check + join-tree construction via GYO reduction (paper §3).

The GYO (Graham / Yu–Özsoyoğlu) reduction repeatedly removes *ears*: an atom
A is an ear if every variable of A that also occurs elsewhere is covered by
a single other atom W (the witness).  Removing ears until one atom remains
certifies α-acyclicity, and the removal order yields a join tree (A hangs
under its witness).  Linear-time in query size for our purposes (queries are
tiny next to data).

``JoinTree`` supports re-rooting (the 0MA/guarded rewrites root the tree at
the guard, paper §4.1) and pre/post-order traversals.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.query import Atom


@dataclasses.dataclass(eq=False)
class JoinTree:
    """Rooted join tree over atom aliases.

    Hashable/comparable by structural content (root, edge set, atoms) so
    plans embedding a tree can serve as cache keys in the serving tier.
    """

    root: str
    parent: dict[str, str | None]
    atoms: dict[str, Atom]

    def cache_key(self) -> tuple:
        return (self.root,
                tuple(sorted((a, p or "") for a, p in self.parent.items())),
                tuple(sorted(self.atoms.items())))

    def __eq__(self, other):
        return (isinstance(other, JoinTree)
                and self.cache_key() == other.cache_key())

    def __hash__(self):
        return hash(self.cache_key())

    def children(self, alias: str) -> list[str]:
        return sorted(a for a, p in self.parent.items() if p == alias)

    def postorder(self) -> list[str]:
        out: list[str] = []

        def rec(u: str):
            for c in self.children(u):
                rec(c)
            out.append(u)

        rec(self.root)
        return out

    def edges_bottom_up(self) -> list[tuple[str, str]]:
        """(parent, child) pairs in the order semi-joins/FreqJoins run:
        children fully processed before their parent consumes them."""
        out: list[tuple[str, str]] = []
        for u in self.postorder():
            p = self.parent[u]
            if p is not None:
                out.append((p, u))
        return out

    def shared_vars(self, u: str, v: str) -> tuple[str, ...]:
        su = set(self.atoms[u].vars)
        return tuple(x for x in self.atoms[v].vars if x in su)

    def rerooted(self, new_root: str) -> "JoinTree":
        """Reorient edges so `new_root` is the root (paper: the guard may be
        chosen as root because join trees are freely re-rootable)."""
        if new_root not in self.atoms:
            raise KeyError(new_root)
        adj: dict[str, set[str]] = {a: set() for a in self.atoms}
        for a, p in self.parent.items():
            if p is not None:
                adj[a].add(p)
                adj[p].add(a)
        parent: dict[str, str | None] = {new_root: None}
        stack = [new_root]
        seen = {new_root}
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    parent[v] = u
                    stack.append(v)
        return JoinTree(new_root, parent, dict(self.atoms))


def build_join_tree(atoms: tuple[Atom, ...]) -> JoinTree | None:
    """GYO reduction. Returns a join tree, or None if the CQ is cyclic."""
    if not atoms:
        raise ValueError("empty query")
    remaining = {a.alias: set(a.vars) for a in atoms}
    atom_map = {a.alias: a for a in atoms}
    parent: dict[str, str | None] = {}

    def occurs_elsewhere(alias: str, var: str) -> bool:
        return any(var in vs for al, vs in remaining.items() if al != alias)

    progress = True
    while len(remaining) > 1 and progress:
        progress = False
        for alias in sorted(remaining):
            core = {v for v in remaining[alias] if occurs_elsewhere(alias, v)}
            witness = None
            for other in sorted(remaining):
                if other != alias and core <= remaining[other]:
                    witness = other
                    break
            if witness is not None:
                parent[alias] = witness
                del remaining[alias]
                progress = True
                break
    if len(remaining) > 1:
        return None  # cyclic
    root = next(iter(remaining))
    parent[root] = None
    return JoinTree(root, parent, atom_map)
