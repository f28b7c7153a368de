"""K2 `with_l` (csrc/flash_fwd_sm90.cu, the d=64 training forward that
writes the lse) against its roofline: the least time of the window's
launches with the lse, from their shapes (harness/work.flash_fwd_work
with lse=True), over the device seconds inside the program's
`kernel.K2_with_l` spans, in percent."""

from benchmark.harness import common, spans, work


def read(r):
    tl, log = r.get('timeline'), r.get('launches')
    if tl is None or log is None:
        return None
    launches = [x for x in log.flash if x[5]]
    seconds = spans.device_s(tl, ('kernel.K2_with_l',))
    if not launches or not seconds:
        return None
    bound = sum(common.bound_s(*work.flash_fwd_work(b, h, sq, sk, d,
                                                    lse=True))
                for b, h, sq, sk, d, _ in launches)
    return 100.0 * bound / seconds
