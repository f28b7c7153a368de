"""The readers of the program's spans (harness/spans.py and the seven
per-layer metrics built on it) on synthetic Timelines: nested ranges, a
device gap with no program span open on the host, an activity launched
outside every range, and a run without the program's spans (the parent
of the change that added them), which must read None and not 0."""

from types import SimpleNamespace

import pytest

from benchmark.harness import common, spans, trace, work


def read(name, r):
    return common.metric_reader(name).read(r)


def sr_timeline():
    """Two clips' worth of a served window (0, 10)."""
    return trace.Timeline(
        device=[('eager_a', 1.5, 2.0), ('flash_fwd_d64', 2.0, 3.0),
                ('gemm', 3.0, 3.5), ('fused_tconv3', 3.5, 4.0),
                ('add', 4.0, 5.0),
                ('copy_outside', 6.0, 6.5),        # in no range at all
                ('late', 9.5, 10.5)],              # past the window's end
        host=[('window', 0.0, 10.0), ('jobs.wait_input', 0.0, 0.5),
              ('sr.text', 0.5, 1.0), ('sr.denoise', 1.0, 5.6),
              ('sampler.step', 1.0, 5.6), ('unet.call', 1.1, 5.5),
              ('kernel.K1', 1.9, 1.95), ('kernel.K5', 2.6, 2.65),
              ('jobs.to_host', 5.6, 6.0), ('aten::copy_', 5.7, 5.9),
              ('jobs.save', 8.0, 9.0)],
        window=(0.0, 10.0),
        ranges=[('sampler.step', 1.5, 5.0), ('unet.call', 1.5, 5.0),
                ('kernel.K1', 2.0, 3.0), ('kernel.K5', 3.5, 4.0)])


def train_timeline():
    """Two steps' worth of a training window (0, 10)."""
    return trace.Timeline(
        device=[('conv', 1.1, 1.6), ('conv', 1.6, 2.0), ('gemm', 2.1, 2.9),
                ('eager', 3.1, 3.5), ('flash_fwd_d64', 3.5, 3.7),
                ('eager', 3.7, 6.0), ('flash_fwd_d64', 6.0, 6.2),
                ('eager', 6.2, 6.5), ('flash_bwd', 6.5, 7.0),
                ('adam', 7.0, 7.9)],
        host=[('window', 0.0, 10.0), ('train.batch', 0.0, 3.0),
              ('batch.to_device', 0.0, 1.0), ('batch.vae_encode', 1.0, 2.0),
              ('batch.t5', 2.0, 3.0), ('train.step', 3.0, 8.0),
              ('gc', 4.0, 4.25), ('gc', 8.5, 8.75), ('train.row', 8.0, 9.0)],
        window=(0.0, 10.0),
        ranges=[('batch.vae_encode', 1.1, 2.0), ('batch.t5', 2.1, 2.9),
                ('train.step', 3.1, 7.9), ('kernel.K2_with_l', 3.5, 3.7),
                ('kernel.K2_with_l', 6.0, 6.2), ('kernel.K3', 6.5, 7.0)])


def parent(tl):
    """The same run without the program's spans."""
    return trace.Timeline(
        device=list(tl.device),
        host=[h for h in tl.host if h[0] in ('window', 'aten::copy_')],
        window=tl.window, ranges=[])


def test_patterns_name_a_span_or_every_span_under_a_prefix():
    assert spans.matches('kernel.K2_with_l', ('kernel.',))
    assert spans.matches('gc', ('gc',)) and not spans.matches('gcx', ('gc',))
    assert not spans.matches('kernel', ('kernel.',))
    assert not spans.matches('unet.call2', ('unet.call',))


def test_device_seconds_inside_and_outside_nested_ranges():
    tl = sr_timeline()
    # sampler.step and unet.call project onto one stretch: counted once
    assert spans.device_s(tl, ('sampler.step', 'unet.call')) == \
        pytest.approx(3.5)
    assert spans.device_s(tl, ('unet.call',), outside=('kernel.',)) == \
        pytest.approx(2.0)
    assert spans.device_s(tl, ('kernel.',)) == pytest.approx(1.5)
    # the copy launched outside every range belongs to none
    assert spans.device_s(tl, ('kernel.', 'unet.call')) == pytest.approx(3.5)
    assert spans.device_s(tl, ('dit.call',)) is None


def test_host_seconds_count_nested_spans_once_and_clip_to_the_window():
    tl = train_timeline()
    assert spans.host_s(tl, ('gc',)) == pytest.approx(0.5)
    assert spans.host_s(tl, ('train.batch', 'batch.')) == pytest.approx(3.0)
    tl.window = (0.0, 8.6)
    assert spans.host_s(tl, ('gc',)) == pytest.approx(0.35)
    assert spans.host_s(tl, ('jobs.',)) is None


def test_idle_gaps_are_named_by_the_span_open_at_their_midpoint():
    tl = sr_timeline()
    assert spans.idle_gaps(tl) == [(0.0, 1.5), (5.0, 6.0), (6.5, 9.5)]
    # (0, 1.5) has its midpoint in sr.text, (5, 6) in sr.denoise;
    # (6.5, 9.5) in jobs.save, outside every sr.* span
    assert spans.idle_outside_s(tl, ('sr.',)) == pytest.approx(3.0)
    # a gap whose midpoint no program span holds
    tl.host = [h for h in tl.host if h[0] != 'jobs.save']
    program = ('jobs.', 'sr.', 'sampler.', 'unet.', 'kernel.')
    assert spans.idle_outside_s(tl, program) == pytest.approx(3.0)
    tl.host.append(('jobs.save', 7.0, 9.0))
    assert spans.idle_outside_s(tl, program) == pytest.approx(0.0)
    assert spans.idle_outside_s(tl, ('train.',)) is None
    tl.device = []          # a trace of the host alone says nothing
    assert spans.idle_outside_s(tl, program) is None


def test_sr_readers():
    r = {'timeline': sr_timeline(), 'units': 2}
    assert read('unet_eager_s.sr', r) == pytest.approx(1.0)
    assert read('serving_idle_s.sr', r) == pytest.approx(1.5)


def test_train_readers():
    log = SimpleNamespace(flash=[(1, 48, 9680, 9680, 64, True)] * 2
                          + [(2, 5, 14400, 14400, 64, False)])
    r = {'timeline': train_timeline(), 'units': 2, 'launches': log}
    assert read('t5_s.train', r) == pytest.approx(0.4)
    assert read('vae_encode_s.train', r) == pytest.approx(0.45)
    assert read('gc_s.train', r) == pytest.approx(0.25)
    # train.step less the K2 `with_l` and K3 launchers' spans
    assert read('step_eager_s.train', r) == pytest.approx(3.9 / 2)
    bound = 2 * common.bound_s(*work.flash_fwd_work(1, 48, 9680, 9680, 64,
                                                    lse=True))
    assert read('k2l_roofline.train', r) == pytest.approx(100 * bound / 0.4)


def test_a_loop_without_a_collection_reads_zero_gc():
    tl = train_timeline()
    tl.host = [h for h in tl.host if h[0] != 'gc']
    assert read('gc_s.train', {'timeline': tl, 'units': 2}) == 0.0


@pytest.mark.parametrize('name', ['unet_eager_s.sr', 'serving_idle_s.sr',
                                  't5_s.train', 'vae_encode_s.train',
                                  'gc_s.train', 'step_eager_s.train',
                                  'k2l_roofline.train'])
def test_a_run_without_the_spans_reads_none(name):
    log = SimpleNamespace(flash=[(1, 48, 9680, 9680, 64, True)])
    for tl in (parent(sr_timeline()), parent(train_timeline())):
        assert read(name, {'timeline': tl, 'units': 2,
                           'launches': log}) is None
    assert read(name, {'timeline': None, 'units': 2,
                       'launches': log}) is None
