"""The whole unit's share of the card's bf16 peak: model FLOPs of the
units the window completed (a saved clip, a train step), counted once on
the plain reference at the cell's shapes (harness/work.FlopCount), over
the window's seconds times 989 TFLOP/s, in percent."""

from benchmark.harness import common


def read(r):
    flops = r.get('model_flops_per_unit')
    if not flops or not r.get('units'):
        return None
    return 100.0 * r['units'] * flops / (r['window_s']
                                         * common.PEAK_BF16_FLOPS)
