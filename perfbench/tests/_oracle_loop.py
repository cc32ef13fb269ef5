"""A frozen copy of the repository's tests/oracle.py loop (``mi_loop``): the
recursion and its occupancies by explicit loops, for the benchmark's own
CPU tests of its vectorised reference."""
import numpy as np

NEG_INF = -np.inf


def _logadd(a, b):
    if a == NEG_INF and b == NEG_INF:
        return NEG_INF
    m = max(a, b)
    return m + np.log1p(np.exp(-abs(a - b)))


def mi_loop(px, py, boundary=None, ans_grad=None):
    """Forward + occupancy backward via explicit loops.

    Args:
      px: (B, S, T+1) regular or (B, S, T) modified.
      py: (B, S+1, T).
      boundary: (B, 4) ints or None.
      ans_grad: (B,) seed for the backward; defaults to ones.

    Returns:
      scores (B,), px_grad (same shape as px), py_grad (same shape as py),
      p (B, S+1, T+1) with unreachable cells at -inf.
    """
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    B, S, T1 = px.shape
    T = py.shape[2]
    modified = T1 == T
    if boundary is None:
        boundary = np.tile(np.array([0, 0, S, T]), (B, 1))
    boundary = np.asarray(boundary, dtype=np.int64)
    if ans_grad is None:
        ans_grad = np.ones((B,), dtype=np.float64)

    scores = np.zeros((B,))
    px_grad = np.zeros_like(px)
    py_grad = np.zeros_like(py)
    p_out = np.full((B, S + 1, T + 1), NEG_INF)

    for b in range(B):
        sb, tb, se, te = boundary[b]
        p = np.full((S + 2, T + 2), NEG_INF)  # 1-based padding of -inf
        p[sb + 1, tb + 1] = 0.0
        for s in range(sb, se + 1):
            for t in range(tb, te + 1):
                if s == sb and t == tb:
                    continue
                if modified:
                    term_x = (
                        p[s, t] + px[b, s - 1, t - 1]
                        if (s > sb and t > tb)
                        else NEG_INF
                    )
                else:
                    term_x = p[s, t + 1] + px[b, s - 1, t] if s > sb else NEG_INF
                term_y = p[s + 1, t] + py[b, s, t - 1] if t > tb else NEG_INF
                p[s + 1, t + 1] = _logadd(term_x, term_y)
        scores[b] = p[se + 1, te + 1]
        p_out[b] = p[1:, 1:]

        # Backward: occupancy gradients of scores[b] w.r.t. px/py.
        g = np.zeros((S + 1, T + 1))
        g[se, te] = ans_grad[b]
        for s in range(se, sb - 1, -1):
            for t in range(te, tb - 1, -1):
                here = p[s + 1, t + 1]
                if here == NEG_INF:
                    continue
                # contribution to (s+1, t[+1]) via px[s, t]
                if modified:
                    if s < se and t < te:
                        dest = p[s + 2, t + 2]
                        if dest != NEG_INF:
                            w = np.exp(here + px[b, s, t] - dest)
                            px_grad[b, s, t] = w * g[s + 1, t + 1]
                            g[s, t] += px_grad[b, s, t]
                else:
                    if s < se:
                        dest = p[s + 2, t + 1]
                        if dest != NEG_INF and px[b, s, t] != NEG_INF:
                            w = np.exp(here + px[b, s, t] - dest)
                            px_grad[b, s, t] = w * g[s + 1, t]
                            g[s, t] += px_grad[b, s, t]
                # contribution to (s, t+1) via py[s, t]
                if t < te:
                    dest = p[s + 1, t + 2]
                    if dest != NEG_INF and py[b, s, t] != NEG_INF:
                        w = np.exp(here + py[b, s, t] - dest)
                        py_grad[b, s, t] = w * g[s, t + 1]
                        g[s, t] += py_grad[b, s, t]

    return scores, px_grad, py_grad, p_out
