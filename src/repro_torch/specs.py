"""The spec grammar of the user-facing strings, the port's own copy.

Three axes are configured by short strings, with the same grammar and the
same error messages as the JAX package:

    solver    "rank1" | "block:K[:adapt][:cold]"
    comm      "dense" | "int8" | "topk:r"
    topology  "flat" | "ring" | "gossip:k" | "hier:g"

A malformed spec raises :class:`SpecError`. The port runs every kind the
parsers return (``PORTED``); :func:`validate` still raises
:class:`NotYetPorted` for a kind missing from ``PORTED``, before any device
work, so a kind added to a parser without its code path fails there rather
than half-way through a run.
"""
from __future__ import annotations

from typing import NamedTuple


class SpecError(ValueError):
    """A malformed spec string (solver, comm, or topology axis).

    Subclasses ``ValueError`` so pre-existing ``except ValueError`` /
    ``pytest.raises(ValueError)`` call sites are unaffected by the move to
    the shared grammar.
    """


# ---------------------------------------------------------------------------
# solver= axis
# ---------------------------------------------------------------------------


class SolverSpec(NamedTuple):
    """Parsed LMO solver tier (see ``parse_solver``)."""

    kind: str  # "rank1" | "block"
    k: int  # block width (1 for rank1)
    adaptive: bool  # spectral-gap-adaptive K(t): stop iterating early
    cold: bool  # ignore the carried warm-start probe (ablation knob)


def parse_solver(spec) -> SolverSpec:
    """Parse a solver spec string — THE single validation point shared by
    ``frank_wolfe.fit``, ``launch.dfw.fit``/``fit_serial`` and ``DFWConfig``.

    Grammar::

        "rank1"                  paper's rank-1 LMO (Algorithm 2)
        "block:K"                rank-K block LMO (BlockFW tier)
        "block:K:adapt"          + spectral-gap-adaptive power iterations
        "block:K:cold"           + ignore the warm-start probe (ablation)
        "block:K:adapt:cold"     flags compose in any order

    Raises ``SpecError`` on malformed specs — ``block:0``, ``block:-3``,
    ``block:`` (no k), unknown flags, unknown solver names. An already-parsed
    ``SolverSpec`` passes through unchanged.
    """
    if isinstance(spec, SolverSpec):
        return spec
    if not isinstance(spec, str):
        raise SpecError(
            f"solver spec must be a string, got {type(spec).__name__}"
        )
    if spec == "rank1":
        return SolverSpec(kind="rank1", k=1, adaptive=False, cold=False)
    if spec == "block" or spec.startswith("block:"):
        parts = spec.split(":")
        if len(parts) < 2 or parts[1] == "":
            raise SpecError(
                f"solver {spec!r}: block solver needs a width, e.g. 'block:4'"
            )
        try:
            k = int(parts[1])
        except ValueError:
            raise SpecError(
                f"solver {spec!r}: block width {parts[1]!r} is not an integer"
            ) from None
        if k < 1:
            raise SpecError(
                f"solver {spec!r}: block width must be >= 1, got {k}"
            )
        adaptive = cold = False
        for flag in parts[2:]:
            if flag == "adapt":
                adaptive = True
            elif flag == "cold":
                cold = True
            else:
                raise SpecError(
                    f"solver {spec!r}: unknown flag {flag!r} "
                    "(expected 'adapt' and/or 'cold')"
                )
        return SolverSpec(kind="block", k=k, adaptive=adaptive, cold=cold)
    raise SpecError(
        f"unknown solver {spec!r} (expected 'rank1' or 'block:K[:adapt][:cold]')"
    )


# ---------------------------------------------------------------------------
# comm= axis
# ---------------------------------------------------------------------------


class CommSpec(NamedTuple):
    """Parsed wire encoding (see ``parse_comm``)."""

    kind: str  # "dense" | "int8" | "topk"
    k: int  # topk keep-count per vector (0 for dense/int8)
    spec: str  # canonical round-trippable string


def parse_comm(spec) -> CommSpec:
    """Parse a ``comm=`` encoding spec.

    Grammar::

        "dense"     exact f32 psum (the paper's master aggregate)
        "int8"      stochastic-rounding s8 psum + shared f32 scale
        "topk:r"    keep the r largest-|.| components, error feedback

    Raises ``SpecError`` on unknown names and ``topk`` with a missing,
    non-integer, or < 1 keep-count. The messages are byte-identical to the
    pre-``specs`` ``make_reducer`` errors. An already-parsed ``CommSpec``
    passes through unchanged.
    """
    if isinstance(spec, CommSpec):
        return spec
    if not isinstance(spec, str):
        raise SpecError(
            f"comm spec must be a string, got {type(spec).__name__}"
        )
    if spec == "dense":
        return CommSpec(kind="dense", k=0, spec="dense")
    if spec == "int8":
        return CommSpec(kind="int8", k=0, spec="int8")
    if spec.startswith("topk:"):
        parts = spec.split(":")
        try:
            k = int(parts[1])
        except ValueError:
            raise SpecError(
                f"comm spec {spec!r}: keep count {parts[1]!r} is not an integer"
            ) from None
        if k < 1:
            raise SpecError(f"comm spec {spec!r}: k must be >= 1")
        return CommSpec(kind="topk", k=k, spec=f"topk:{k}")
    raise SpecError(
        f"unknown comm spec {spec!r} (expected 'dense', 'int8' or 'topk:r')"
    )


# ---------------------------------------------------------------------------
# topology= axis
# ---------------------------------------------------------------------------


class TopologySpec(NamedTuple):
    """Parsed exchange graph (see ``parse_topology``)."""

    kind: str  # "flat" | "gossip" | "hier"
    degree: int  # gossip neighbor degree (2 for ring; 0 otherwise)
    groups: int  # hier group count (1 otherwise)
    spec: str  # canonical round-trippable string


def parse_topology(spec) -> TopologySpec:
    """Parse a ``topology=`` exchange-graph spec.

    Grammar::

        "flat"       one global all-reduce domain (today's psum master)
        "ring"       degree-2 gossip: each worker averages with its +-1
                     ring neighbors ("gossip:2" is the same graph)
        "gossip:k"   k-regular gossip over ring offsets +-1..+-k/2
                     (k even, so the mixing matrix stays symmetric)
        "hier:g"     two-level reduce: g groups, exact psum inside each
                     group, reducer-encoded exchange across groups

    Structural validation only — constraints that depend on the worker
    count (gossip degree < N, N divisible by g) are checked by
    ``comm.topology.make_topology`` where N is known. Raises ``SpecError``
    on malformed specs; an already-parsed ``TopologySpec`` passes through
    unchanged.
    """
    if isinstance(spec, TopologySpec):
        return spec
    if not isinstance(spec, str):
        raise SpecError(
            f"topology spec must be a string, got {type(spec).__name__}"
        )
    if spec == "flat":
        return TopologySpec(kind="flat", degree=0, groups=1, spec="flat")
    if spec == "ring":
        return TopologySpec(kind="gossip", degree=2, groups=1, spec="ring")
    if spec == "gossip" or spec.startswith("gossip:"):
        parts = spec.split(":")
        if len(parts) < 2 or parts[1] == "":
            raise SpecError(
                f"topology {spec!r}: gossip needs a degree, e.g. 'gossip:2'"
            )
        try:
            k = int(parts[1])
        except ValueError:
            raise SpecError(
                f"topology {spec!r}: gossip degree {parts[1]!r} is not an "
                "integer"
            ) from None
        if k < 2:
            raise SpecError(
                f"topology {spec!r}: gossip degree must be >= 2, got {k}"
            )
        if k % 2 != 0:
            raise SpecError(
                f"topology {spec!r}: gossip degree must be even (the graph "
                f"uses symmetric ring offsets +-1..+-k/2), got {k}"
            )
        return TopologySpec(
            kind="gossip", degree=k, groups=1, spec=f"gossip:{k}"
        )
    if spec == "hier" or spec.startswith("hier:"):
        parts = spec.split(":")
        if len(parts) < 2 or parts[1] == "":
            raise SpecError(
                f"topology {spec!r}: hier needs a group count, e.g. 'hier:2'"
            )
        try:
            g = int(parts[1])
        except ValueError:
            raise SpecError(
                f"topology {spec!r}: group count {parts[1]!r} is not an "
                "integer"
            ) from None
        if g < 2:
            raise SpecError(
                f"topology {spec!r}: group count must be >= 2, got {g} "
                "(one group is just 'flat')"
            )
        return TopologySpec(kind="hier", degree=0, groups=g, spec=f"hier:{g}")
    raise SpecError(
        f"unknown topology {spec!r} "
        "(expected 'flat', 'ring', 'gossip:k' or 'hier:g')"
    )


# ---------------------------------------------------------------------------
# Cross-axis validation — the one entry-point gate
# ---------------------------------------------------------------------------


class NotYetPorted(NotImplementedError):
    """A valid spec or setting whose code path the port does not have yet."""


#: What the port runs, per axis.
PORTED = {"solver": ("rank1", "block"), "comm": ("dense", "int8", "topk"),
          "topology": ("flat", "gossip", "hier")}


def validate(
    *, solver="rank1", comm="dense", topology="flat"
) -> "tuple[SolverSpec, CommSpec, TopologySpec]":
    """Parse all three axes (``SpecError`` when malformed), apply the
    reference's cross-axis rules, and raise ``NotYetPorted`` for any axis
    value the port does not run yet."""
    s = parse_solver(solver)
    c = parse_comm(comm)
    t = parse_topology(topology)
    if t.kind == "gossip" and s.kind != "rank1":
        raise SpecError(
            f"topology {t.spec!r} requires solver 'rank1' (per-node gap "
            f"certificates are rank-1 quantities), got solver {s!r}"
        )
    if t.kind == "gossip" and c.kind != "dense":
        raise SpecError(
            f"topology {t.spec!r} requires comm 'dense' (gossip exchanges "
            f"are neighbor averages, not compressible collectives), got "
            f"comm {c.spec!r}"
        )
    for axis, kind, given in (
        ("solver", s.kind, solver), ("comm", c.kind, comm), ("topology", t.kind, topology),
    ):
        if kind not in PORTED[axis]:
            raise NotYetPorted(
                f"{axis} {given!r} is valid but not yet ported to PyTorch; "
                f"the port runs {axis} in {PORTED[axis]}"
            )
    return s, c, t
