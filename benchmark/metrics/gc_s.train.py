"""Host seconds per step inside the program's `gc` spans: Python's
garbage collections during the train loop (gc_spans), each a range from
its start to its stop on the thread that collected. A loop that records
its steps but no collection reads 0."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.host_s(tl, ('gc',))
    if s is None and spans.host_s(tl, ('train.step',)) is not None:
        s = 0.0
    return None if s is None else s / r['units']
