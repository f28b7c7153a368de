"""K9's backward (ops/qk_ln_rope._QkLnRope.backward) against its
roofline: the least time of the window's backward calls (x and dy read,
dx written, the [S, 64] fp32 tables read; harness/work.qk_ln_rope_bwd_work
at the shape of K9's forward launches) over the device time of whatever
runs inside the `qk_ln_rope_backward` range, in percent."""

from benchmark.harness import common, trace, work


def read(r):
    tl, log = r.get('timeline'), r.get('launches')
    if tl is None or log is None or not log.qk or not log.qk_backwards:
        return None
    if len(set(log.qk)) != 1:
        return None      # one shape a cell: the backward's is the forward's
    seconds, _ = trace.seconds_in_ranges(tl, 'qk_ln_rope_backward')
    if seconds <= 0:
        return None
    bound = log.qk_backwards * common.bound_s(
        *work.qk_ln_rope_bwd_work(*log.qk[0]))
    return 100.0 * bound / seconds
