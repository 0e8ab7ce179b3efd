"""Standard protograph ensembles for capacity-approaching QC-LDPC codes.

The reference ships an *irregular* 2^20-bit rate-0.5 code with punctured
(erased) variables reaching 94.9% of capacity (README.md:77-88); its
construction is unpublished and the alist blob is absent from the snapshot.
This module provides equivalent-or-better open constructions as protograph
base matrices for the QC lift in :mod:`ldpc_decoder_tpu.codes.qc`:

- **AR4JA** (Divsalar/Dolinar/Jones, CCSDS 131.1 family): rate-1/2 base
  with one punctured high-degree column; iterative-decoding threshold
  ~0.63 dB Eb/N0 (σ* ≈ 0.93) — far beyond the (3,6) regular ensemble's
  0.88.
- **RU-style irregular bases**: degree profiles from density-evolution
  optimized ensembles (Richardson/Shokrollahi/Urbanke tables), realized as
  integer base matrices (threshold σ* ≈ 0.9497 for the max-d_v-8 profile).

A base matrix entry m > 1 means m parallel edges between that (check,
variable) pair in the protograph; after lifting with distinct circulant
shifts they become disjoint edge sets (the QC expansion resolves
multi-edges).
"""

from __future__ import annotations

import numpy as np

# AR4JA rate-1/2 protomatrix (Divsalar et al., "Capacity-Approaching
# Protograph Codes", IEEE JSAC 2009, Fig. 12). Columns:
# [v0 (transmitted), v1 (PUNCTURED, degree 6), v2, v3, v4]; the last
# column pair carries the accumulate-repeat structure.
AR4JA_RATE_12 = np.array(
    [
        [1, 2, 0, 0, 0],
        [0, 3, 1, 1, 1],
        [0, 1, 2, 2, 1],
    ],
    dtype=np.int8,
)
AR4JA_RATE_12_PUNCTURED_COLS = (1,)


def ar4ja_base(rate_num: int = 1, rate_den: int = 2):
    """AR4JA base matrix + punctured column indices for rate n/(n+2).

    Currently rate 1/2 (the reference's flagship rate). Higher-rate AR4JA
    members extend the base with paired degree-4 columns (JSAC 2009,
    Fig. 13) and can be added the same way.

    Status: the lift machinery (multi-edge expansion, puncturing, grouped
    kernels) is tested end-to-end at small Z, but *naive random shift
    selection does not give a good large-Z AR4JA*: measured BER floors
    ~1e-4 at n=10^6 (small trapping sets through the parallel-edge
    circulants). Production AR4JA needs the girth-aware two-stage lifting
    of CCSDS 131.1; use :func:`ru_irregular_base` for a working
    near-capacity irregular ensemble meanwhile.
    """
    if (rate_num, rate_den) == (1, 2):
        return AR4JA_RATE_12.copy(), AR4JA_RATE_12_PUNCTURED_COLS
    raise ValueError(f"unsupported AR4JA rate {rate_num}/{rate_den}")


def ru_irregular_base(scale: int = 8, seed: int = 0):
    """Integer base matrix realizing the RU max-d_v-8 rate-1/2 ensemble.

    Edge-perspective profile (Richardson/Shokrollahi/Urbanke, "Design of
    capacity-approaching irregular LDPC codes", Table I, max d_v = 8):
    λ(x) = 0.30013 x + 0.28395 x^2 + 0.41592 x^7,
    ρ(x) = 0.22919 x^5 + 0.77081 x^6, threshold σ* = 0.9497.

    Realized as a (3·scale) x (6·scale) 0/1 base matrix with column degrees
    drawn from {2, 3, 8} and row degrees from {6, 7} in the profile's node
    proportions; the QC lift then makes an irregular code with exactly this
    degree distribution. All variables transmitted (no puncturing).
    """
    R, C = 3 * scale, 6 * scale
    # node-perspective fractions: n_j ∝ λ_j / j
    lam = {2: 0.30013, 3: 0.28395, 8: 0.41592}
    node = {j: l / j for j, l in lam.items()}
    tot = sum(node.values())
    counts = {j: int(round(C * f / tot)) for j, f in node.items()}
    counts[2] += C - sum(counts.values())  # rounding slack -> deg-2
    col_deg = np.repeat(
        list(counts.keys()), list(counts.values())
    ).astype(np.int64)
    n_edges = int(col_deg.sum())
    # rows: degrees 6/7 summing to n_edges
    d7 = n_edges - 6 * R
    if not 0 <= d7 <= R:
        raise ValueError("scale incompatible with the degree profile")
    row_deg = np.array([7] * d7 + [6] * (R - d7), dtype=np.int64)

    # degree-constrained 0/1 base: place columns greedily (densest first),
    # sampling distinct rows weighted by remaining row capacity
    rng = np.random.default_rng(seed)
    order = np.argsort(-col_deg)
    for _ in range(200):
        cap = row_deg.astype(np.float64).copy()
        base = np.zeros((R, C), dtype=np.int8)
        ok = True
        for c in order:
            d = int(col_deg[c])
            if (cap > 0).sum() < d:
                ok = False
                break
            p = cap / cap.sum()
            picks = rng.choice(R, size=d, replace=False, p=p)
            base[picks, c] = 1
            cap[picks] -= 1
        if ok and (base.sum(axis=1) == row_deg).all():
            return base, ()
        rng = np.random.default_rng(rng.integers(1 << 31))
    raise RuntimeError("could not realize the degree profile; "
                       "try a larger scale")


def regular_base(R: int, C: int, dv: int, dc: int, seed: int = 0):
    """Random (dv, dc)-regular 0/1 base matrix (configuration model,
    parallel edges rejected).

    Why not the trivial all-ones dv x dc base: QC lifts of *fully
    connected* bases have minimum distance <= (dv+1)! regardless of the
    lift size (MacKay/Davey bound), so a 2^20-bit code built from the
    1x-scale base carries weight-24 codewords — near-threshold BP visibly
    converges onto them. A sparse scaled base escapes the bound while
    keeping the same degree profile and threshold.
    """
    if R * dc != C * dv:
        raise ValueError("degree/size mismatch: R*dc must equal C*dv")
    rng = np.random.default_rng(seed)
    for _ in range(500):
        cap = np.full(R, dc, dtype=np.float64)
        base = np.zeros((R, C), dtype=np.int8)
        ok = True
        for c in range(C):
            if (cap > 0).sum() < dv:
                ok = False
                break
            picks = rng.choice(R, size=dv, replace=False, p=cap / cap.sum())
            base[picks, c] = 1
            cap[picks] -= 1
        if ok and (base.sum(axis=1) == dc).all():
            return base
        rng = np.random.default_rng(rng.integers(1 << 31))
    raise RuntimeError("could not realize a simple regular base")


def prelift_base(base, m: int, seed: int = 0, tries: int = 64):
    """First-stage lift: expand a multi-edge protograph into a 0/1 base.

    Each cell with multiplicity k becomes k size-m circulants with
    *distinct* shifts (so no parallel edges survive), i.e. the CCSDS
    131.1-style two-stage construction's inner lift. Among ``tries`` random
    draws, keeps the one whose pre-lifted base has the fewest base 4-cycle
    patterns (fewer constraints for the second-stage girth repair in
    :func:`codes.qc.make_qc_structure_repair`).

    Column blocks stay contiguous: proto column c maps to columns
    [c*m, (c+1)*m), so a punctured proto column maps to m punctured
    columns.
    """
    from ldpc_decoder_tpu.codes.qc import _cycle_patterns

    base = np.asarray(base)
    R, C = base.shape
    r0, c0 = np.nonzero(base)
    mult = base[r0, c0].astype(np.int64)
    if mult.max(initial=1) > m:
        raise ValueError(f"cell multiplicity {mult.max()} exceeds prelift {m}")
    rng = np.random.default_rng(seed)
    best, best_n4 = None, None
    for _ in range(tries):
        big = np.zeros((R * m, C * m), dtype=np.int8)
        z = np.arange(m)
        for r, c, k in zip(r0, c0, mult):
            shifts = rng.choice(m, size=int(k), replace=False)
            for s in shifts:
                big[r * m + z, c * m + (z + s) % m] = 1
        n4 = _cycle_patterns(big)[1].shape[0]
        if best_n4 is None or n4 < best_n4:
            best, best_n4 = big, n4
    return best


def make_protograph_code_two_stage(
    base, punctured_cols, m: int, Z: int, seed: int = 0,
    coarse=None, fine_mod: int = 4,
):
    """Two-stage girth-aware lift of a multi-edge punctured protograph.

    Stage 1 (:func:`prelift_base`) resolves parallel edges into a 0/1 base
    of size (R*m, C*m); stage 2 (:func:`codes.qc.make_qc_structure_repair`)
    picks seam-lattice circulant shifts by targeted repair until no base 4-
    or 6-cycle pattern closes — the final graph has girth >= 8. This is the
    construction that removes the naive-lift AR4JA BER floor (~1e-4 at
    n=1e6, see :func:`ar4ja_base`).

    n = C*m*Z total variables of which len(punctured_cols)*m*Z are erased
    (reference convention: erased variables last, ldpc_code.cpp:52-76).
    """
    from ldpc_decoder_tpu.codes.qc import (
        make_qc_structure_repair,
        qc_to_code,
    )

    base = np.asarray(base)
    punct = sorted(punctured_cols)
    order = [c for c in range(base.shape[1]) if c not in punct] + punct
    big = prelift_base(base[:, order], m, seed=seed)
    structure = make_qc_structure_repair(
        big, Z, seed=seed, coarse=coarse, fine_mod=fine_mod
    )
    code = qc_to_code(structure, n_erased_vars=len(punct) * m * Z)
    return code, structure


def make_protograph_code(base, punctured_cols, Z: int, seed: int = 0,
                         coarse=None, fine_mod: int = 4):
    """Lift a protograph into an LDPCCode with punctured columns as erased
    variables.

    The reference's alist convention marks the *last* ``#e=`` variables as
    erased (ldpc_code.cpp:52-76, main.cpp:529-530), so punctured base
    columns are permuted to the end before lifting; they are then never
    transmitted (channel value 0 / LLR 0) but are recovered by decoding and
    counted in the error statistics, exactly like the reference's
    174,763-erased-variable flagship code (README.md:81-86).
    """
    from ldpc_decoder_tpu.codes.qc import make_qc_code

    base = np.asarray(base)
    punct = sorted(punctured_cols)
    order = [c for c in range(base.shape[1]) if c not in punct] + punct
    return make_qc_code(base[:, order], Z, seed=seed,
                        n_erased_vars=len(punct) * Z,
                        coarse=coarse, fine_mod=fine_mod)


# The flagship punctured protograph ("p41"): 4x7 rate-1/2-over-transmitted
# base with ONE punctured column (the last, degree 8) and one degree-1
# transmitted column — found by simulated annealing over small integer
# protomatrices under the ITERATION-CONSTRAINED P-EXIT score
# (scripts/optimize_proto.py). Thresholds: sigma*(80 DE iters) = 0.9461,
# sigma*(120) = 0.9549, asymptotic 0.9619.
#
# Measured at n = 1,032,192 (two-stage lift m=8, Z=18432, girth 8,
# coarse=512/fine_mod=64 seam lattice; 512 frames, <=120 iters, bf16
# sum-product): sigma 0.94 -> FER 0, BER 0, avg 71.0 iters; sigma 0.95 ->
# FER 0, avg 98.2; waterfall edge between 0.950 and 0.955 (FER 0.56 at
# 0.955). The reference's unpublished flagship code decodes sigma <= 0.95
# with FER(>=1) 0.047 / BER 2.3e-7 AT sigma 0.94 (README.md:77-115) — this
# construction strictly beats it at both operating points, at 95.8% of
# Shannon at its edge (capacity(0.95) = 0.5219, rate 0.5).
P41_BASE = np.array(
    [
        [0, 1, 1, 0, 1, 0, 3],
        [0, 1, 0, 1, 2, 1, 2],
        [0, 2, 0, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 2],
    ],
    dtype=np.int8,
)
P41_PUNCTURED_COLS = (6,)


def p41_code(Z: int = 18432, seed: int = 3, m: int = 8,
             coarse: int | None = 1024, fine_mod: int = 64):
    """Build the flagship sigma<=0.95 punctured code (see P41_BASE).

    n = 7*m*Z total variables of which m*Z are punctured; rate 1/2 over
    transmitted bits. Defaults give the validated n=1,032,192 instance:
    the coarse=1024 lattice and seed 3 from a seed search, with the
    waterfall qualified at 2048 frames per point: FER 0 at 0.94 and 0.95,
    FER 0.0044 at 0.952 (scripts/out/fer_stats_c1024s3.json).
    """
    return make_protograph_code_two_stage(
        P41_BASE, P41_PUNCTURED_COLS, m=m, Z=Z, seed=seed,
        coarse=coarse, fine_mod=fine_mod,
    )


def p41_shipped_params() -> dict[str, str]:
    """Construction parameters of the shipped p41 instance (the defaults
    of :func:`p41_code`), for the ``#params=`` alist cache header — a
    cached file built with other params (e.g. a round-2 seed-1/coarse-512
    cache) is detected and regenerated instead of silently benchmarked."""
    import inspect

    sig = inspect.signature(p41_code)
    out = {"base": "p41"}
    for k, v in sig.parameters.items():
        out[k] = str(v.default)
    return out


# P-EXIT-optimized 12x24 rate-1/2 base (RU max-d_v-8 degree profile,
# scripts/optimize_base.py: random search + degree-preserving edge-swap
# hill climb maximizing the Gaussian-approximation P-EXIT threshold).
# P-EXIT sigma* = 0.9471 (ensemble limit 0.9497; a random realization of
# the same profile scores ~0.925-0.943).
OPTIMIZED_R12_BASE = np.array(
    [[1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1], [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1], [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1], [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1], [0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0]] , dtype=np.int8)
