"""K3 (csrc/flash_bwd_sm90.cu: preprocess, main, dQ conversion) against
its roofline: the least time of the window's K3 launches, from their
shapes (harness/work.flash_bwd_work), over the device time of the kernels
named `flash_bwd` in the trace, in percent."""

from benchmark.harness import common, trace, work


def read(r):
    tl, log = r.get('timeline'), r.get('launches')
    if tl is None or log is None or not log.flash_bwd:
        return None
    seconds, n = trace.kernel_seconds(tl, 'flash_bwd')
    if n == 0 or seconds <= 0:
        return None
    bound = sum(common.bound_s(*work.flash_bwd_work(*x))
                for x in log.flash_bwd)
    return 100.0 * bound / seconds
