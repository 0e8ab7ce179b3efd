"""Bytes the flood-BP algorithm moves per iteration, counted from shapes.

Divided by a measured per-iteration time this gives achieved bytes/s, and
against the device's peak bandwidth a roofline share. The count is the
algorithm's, not a kernel's: each pass reads every edge message once and
writes it once (the reference's 4*E*sizeof(msg) per iteration, flood.cu:
77-158: one read and one write of the edge array per kernel, two kernels
per iteration), plus the syndrome bytes of the check pass and the channel
LLRs of the variable pass. An implementation that moves more (rotated
copies, f32 temporaries) shows as a lower achieved rate, and one that
skips constant messages (the kernels' degree-1 columns) as a higher one.
"""

from __future__ import annotations


def bytes_split(n_edges: int, n_vars: int, n_checks: int, B: int,
                msg_bytes: int = 2, llr_bytes: int = 2,
                emit: bool = False) -> tuple[int, int]:
    """(check-pass bytes, variable-pass bytes) of ONE iteration at B lanes.

    Check pass: every message read and written, int8 syndromes read.
    Variable pass: every message read and written, channel LLRs read, and
    int8 hard decisions written when ``emit``.
    """
    cn = (2 * n_edges * msg_bytes + n_checks) * B
    vn = (2 * n_edges * msg_bytes + n_vars * llr_bytes
          + (n_vars if emit else 0)) * B
    return cn, vn


def bytes_per_iter(n_edges: int, n_vars: int, n_checks: int, B: int,
                   msg_bytes: int = 2, llr_bytes: int = 2,
                   emit: bool = False) -> int:
    """Bytes moved by ONE iteration (see :func:`bytes_split`)."""
    return sum(bytes_split(n_edges, n_vars, n_checks, B, msg_bytes,
                           llr_bytes, emit))
