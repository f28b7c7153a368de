"""K5 (csrc/fused_tconv3_sm90.cu, GN + SiLU + (3,1,1) conv) against its
roofline: the least time of the window's K5 launches, from their shapes
(harness/work.tconv3_work), over the device time of the kernel
`fused_tconv3` in the trace, in percent."""

from benchmark.harness import common, trace, work


def read(r):
    tl, log = r.get('timeline'), r.get('launches')
    if tl is None or log is None or not log.tconv3:
        return None
    seconds, n = trace.kernel_seconds(tl, 'fused_tconv3')
    if n == 0 or seconds <= 0:
        return None
    bound = sum(common.bound_s(*work.tconv3_work(*x)) for x in log.tconv3)
    return 100.0 * bound / seconds
