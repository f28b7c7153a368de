"""K1 (csrc/flash_fwd_sm90.cu, the d=64 forward without the lse) against
its roofline: the least time of the window's K1 launches, from their
shapes (harness/work.flash_fwd_work), over the device time of the kernel
`flash_fwd_d64` in the trace, in percent."""

from benchmark.harness import common, trace, work


def read(r):
    tl, log = r.get('timeline'), r.get('launches')
    if tl is None or log is None:
        return None
    launches = [x for x in log.flash if x[4] == 64 and not x[5]]
    if not launches or any(x[5] for x in log.flash if x[4] == 64):
        return None     # K2 `with_l` shares the kernel's name
    seconds, n = trace.kernel_seconds(tl, 'flash_fwd_d64')
    if n == 0 or seconds <= 0:
        return None
    bound = sum(common.bound_s(*work.flash_fwd_work(b, h, sq, sk, d))
                for b, h, sq, sk, d, _ in launches)
    return 100.0 * bound / seconds
