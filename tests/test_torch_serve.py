"""The port's serving daemon and its tail (cli/serve.py, cli/web.py,
cli/warm_cache.py, utils/profiling.py, STARPipeline.warm):

  * the counterparts of tests/test_serve.py and tests/test_web.py on the
    port's serve_loop, job_states and serve_web, with the same stub pipe
    and clips written through cv2: the file protocol, a failing job that
    does not kill the daemon, the shutdown sentinel winning each loop
    entry, HTTP enqueue / jobs / result / upload / video, and the HTTP ->
    queue -> daemon -> result round trip; the done files are the JAX
    daemon's, key for key, on the same queue;
  * serve_loop with in-memory load and save (as chip_smoke.py drives it);
  * serve.main on the CPU at tiny widths (--warm, one request, shutdown);
  * STARPipeline.warm on a tiny CPU pipeline: it runs, and a clip after it
    equals one without it;
  * StepTimer against star_tpu's (tests/test_aux.py), profiling.trace
    writing a Chrome trace with an annotated region, sync;
  * warm_cache.main raising when there is no nvcc.
"""

import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from star_tpu_torch.cli import serve, warm_cache
from star_tpu_torch.cli.serve import serve_loop
from star_tpu_torch.cli.web import job_states, serve_web
from star_tpu_torch.config import SamplerConfig
from star_tpu_torch.ops import _build
from star_tpu_torch.pipeline import build_pipeline
from star_tpu_torch.utils import profiling
from test_serve import StubPipe, _write_clip
from test_torch_cli import TINY_CFG, tiny_star_models


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tiny pipelines slow tenfold with a thread
    per core when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_until_done(loop, qdir, done_names, timeout=30.0):
    """Run `loop()` (a serve_loop) in a thread until every done file is
    there, then write the shutdown sentinel and join it."""
    t = threading.Thread(target=loop)
    t.start()
    deadline = time.time() + timeout
    while time.time() < deadline and not all(
            (qdir / f'{n}.done.json').exists() for n in done_names):
        time.sleep(0.05)
    (qdir / 'shutdown').write_text('')
    t.join(timeout=10)
    assert not t.is_alive()


def test_serve_loop_processes_queue_and_shuts_down(tmp_path):
    qdir, sdir = tmp_path / 'q', tmp_path / 'out'
    qdir.mkdir()
    clip = str(tmp_path / 'in.mp4')
    _write_clip(clip)
    (qdir / 'a.json').write_text(json.dumps(
        {'input_path': clip, 'prompt': 'hello', 'seed': 7,
         'output_name': 'a_out.mp4'}))
    (qdir / 'b.json').write_text(json.dumps(
        {'input_path': clip, 'prompt': 'boom'}))
    (qdir / 'shutdown').write_text('')

    pipe = StubPipe()
    serve_loop(pipe, str(qdir), str(sdir), poll_secs=0.01)
    # the shutdown sentinel is consumed before the requests: nothing ran
    assert not pipe.calls and not (qdir / 'shutdown').exists()
    (qdir / 'shutdown').write_text('')
    serve_loop(pipe, str(qdir), str(sdir), poll_secs=0.01)
    assert not pipe.calls                 # it wins each loop entry

    run_until_done(functools.partial(serve_loop, pipe, str(qdir), str(sdir),
                                     0.01), qdir, ('a', 'b'))
    a = json.loads((qdir / 'a.done.json').read_text())
    assert a['ok'] and os.path.exists(a['output'])
    assert a['output'] == str(sdir / 'a_out.mp4')
    assert sorted(a) == ['ok', 'output', 'seconds']
    b = json.loads((qdir / 'b.done.json').read_text())
    assert not b['ok'] and b['error'] == 'RuntimeError: denoiser exploded'
    assert sorted(b) == ['error', 'ok', 'seconds']
    # the daemon survived the failing job and ran both, in sorted order
    assert [c[1:] for c in pipe.calls] == [('hello', 7), ('boom', 666)]
    assert sorted(os.listdir(qdir)) == ['a.done.json', 'b.done.json']


def test_done_files_match_the_jax_daemons(tmp_path):
    """The same queue through star_tpu's serve_loop and the port's: the
    same done files, key for key, value for value (seconds aside)."""
    from star_tpu.cli.serve import serve_loop as jax_serve_loop
    clip = str(tmp_path / 'in.mp4')
    _write_clip(clip)
    results = []
    for name, loop in (('jax', jax_serve_loop), ('port', serve_loop)):
        qdir, sdir = tmp_path / name / 'q', tmp_path / 'out'
        qdir.mkdir(parents=True)
        for job, prompt in (('a', 'hello'), ('b', 'boom')):
            (qdir / f'{job}.json').write_text(json.dumps(
                {'input_path': clip, 'prompt': prompt}))
        run_until_done(functools.partial(loop, StubPipe(), str(qdir),
                                         str(sdir), 0.01), qdir, ('a', 'b'))
        res = {}
        for job in ('a', 'b'):
            res[job] = json.loads((qdir / f'{job}.done.json').read_text())
            assert res[job].pop('seconds') >= 0
        results.append(res)
    assert results[0] == results[1]


def test_serve_loop_with_in_memory_load_and_save(tmp_path):
    qdir = tmp_path / 'q'
    qdir.mkdir()
    clips = {'mem://clip': np.full((4, 12, 16, 3), 7, np.uint8)}
    saved = {}

    def load(path):
        return clips[path], 16.0

    def save(frames, save_dir, name, fps=16.0):
        saved[name] = (frames, save_dir, fps)
        return name
    (qdir / 'a.json').write_text(json.dumps({'input_path': 'mem://clip',
                                             'output_name': 'a.mp4'}))
    (qdir / 'b.json').write_text(json.dumps({'input_path': 'mem://none'}))
    pipe = StubPipe()
    run_until_done(functools.partial(serve_loop, pipe, str(qdir), 'out', 0.01,
                                     load=load, save=save), qdir, ('a', 'b'))
    a = json.loads((qdir / 'a.done.json').read_text())
    assert a['ok'] and a['output'] == 'a.mp4'
    frames, save_dir, fps = saved['a.mp4']
    assert frames.shape == (4, 48, 64, 3) and save_dir == 'out' and fps == 16
    assert pipe.calls == [((4, 12, 16, 3), 'a good video', 666)]
    b = json.loads((qdir / 'b.done.json').read_text())
    assert not b['ok'] and b['error'] == "KeyError: 'mem://none'"


# ------------------------------------------------------------------- web

@pytest.fixture()
def web(tmp_path):
    qdir, sdir, udir = (tmp_path / 'q', tmp_path / 'out', tmp_path / 'up')
    qdir.mkdir(), sdir.mkdir()
    srv = serve_web(str(qdir), str(sdir), str(udir), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    yield base, qdir, sdir, udir
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _req(url, data, method='POST', ctype='application/json'):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={'Content-Type': ctype})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_enqueue_json_and_form(web):
    base, qdir, _, _ = web
    st, body = _req(f'{base}/enqueue', json.dumps(
        {'input_path': '/x/a.mp4', 'prompt': 'p', 'seed': 3}).encode())
    assert st == 200
    job = json.loads(body)['job']
    assert json.load(open(qdir / f'{job}.json')) == {
        'input_path': '/x/a.mp4', 'prompt': 'p', 'seed': 3}

    time.sleep(0.002)       # job names are milliseconds
    st, body = _req(f'{base}/enqueue', b'input_path=%2Fx%2Fb.mp4&seed=7',
                    ctype='application/x-www-form-urlencoded')
    assert st == 200
    req2 = json.load(open(qdir / f'{json.loads(body)["job"]}.json'))
    assert req2['input_path'] == '/x/b.mp4' and req2['seed'] == 7
    assert req2['prompt'] == 'a good video'          # the default

    st, body = _req(f'{base}/enqueue', json.dumps({'prompt': 'x'}).encode())
    assert st == 400 and b'input_path' in body
    st, _ = _req(f'{base}/elsewhere', b'{}')
    assert st == 404


def test_jobs_and_result_lifecycle(web):
    base, qdir, _, _ = web
    _, body = _req(f'{base}/enqueue',
                   json.dumps({'input_path': '/x/a.mp4'}).encode())
    job = json.loads(body)['job']
    assert json.loads(_get(f'{base}/jobs')[1])[job]['state'] == 'queued'
    st, body = _get(f'{base}/result/{job}')
    assert st == 404 and json.loads(body)['state'] == 'queued'

    os.rename(qdir / f'{job}.json', qdir / f'{job}.json.working')
    assert job_states(str(qdir))[job] == {'state': 'working'}
    (qdir / f'{job}.json.working').unlink()
    (qdir / f'{job}.done.json').write_text(
        json.dumps({'ok': True, 'output': 'o.mp4', 'seconds': 1.0}))
    assert json.loads(_get(f'{base}/jobs')[1])[job] == {
        'state': 'done', 'result': {'ok': True, 'output': 'o.mp4',
                                    'seconds': 1.0}}
    st, body = _get(f'{base}/result/{job}')
    assert st == 200 and json.loads(body)['ok'] is True
    st, html = _get(f'{base}/')
    assert st == 200 and job.encode() in html
    assert job_states(str(qdir / 'missing')) == {}


def test_upload_and_video_download(web):
    base, _, sdir, udir = web
    st, body = _req(f'{base}/upload/in.mp4', b'\x00\x01abc', method='PUT')
    assert st == 200
    p = json.loads(body)['input_path']
    assert open(p, 'rb').read() == b'\x00\x01abc'
    assert os.path.dirname(p) == str(udir)
    (sdir / 'clip.mp4').write_bytes(b'VID')
    assert _get(f'{base}/video/clip.mp4') == (200, b'VID')
    assert _get(f'{base}/result/%2e%2e%2fevil')[0] == 400   # traversal
    assert _get(f'{base}/video/none.mp4')[0] == 404


def test_http_to_serve_loop_round_trip(web, tmp_path):
    """HTTP enqueue -> file queue -> the port's serve_loop (stub pipe) ->
    the done file over HTTP."""
    base, qdir, sdir, _ = web
    clip = tmp_path / 'in.mp4'
    _write_clip(str(clip))
    _, body = _req(f'{base}/enqueue', json.dumps(
        {'input_path': str(clip), 'output_name': 'out.mp4'}).encode())
    job = json.loads(body)['job']
    run_until_done(functools.partial(serve_loop, StubPipe(), str(qdir),
                                     str(sdir), 0.01), qdir, (job,))
    st, body = _get(f'{base}/result/{job}')
    assert st == 200
    res = json.loads(body)
    assert res['ok'] is True and os.path.exists(res['output'])
    assert _get(f'{base}/video/out.mp4')[0] == 200


# --------------------------------------------------- the daemon end to end

def tiny_pipe():
    return build_pipeline(tiny_star_models(), TINY_CFG(
        sampler=SamplerConfig(steps=2, solver_mode='normal')),
        allow_hash_tokenizer=True, device='cpu')


def test_warm_runs_a_clip_and_changes_no_later_clip():
    frames = np.random.RandomState(3).uniform(0, 255, (4, 20, 16, 3)) \
        .astype(np.uint8)
    warmed = tiny_pipe()
    secs = warmed.warm(4, 20, 16)
    assert isinstance(secs, float) and secs > 0
    np.testing.assert_array_equal(
        warmed.enhance_a_video(frames, 'a cat', seed=5),
        tiny_pipe().enhance_a_video(frames, 'a cat', seed=5))


def test_serve_main_warms_and_serves_on_the_cpu(tmp_path, monkeypatch):
    """serve.main --device cpu --allow_random_weights --warm 4x20x16 at
    tiny widths (bf16, as the daemon serves): one request through the
    queue, equal to the pipeline called directly; then shutdown."""
    monkeypatch.setattr(serve, 'init_random_models', tiny_star_models)
    monkeypatch.setattr(serve, 'PipelineConfig', TINY_CFG)
    warmed = []
    real_warm = serve.build_pipeline

    def build(*a, **kw):
        pipe = real_warm(*a, **kw)
        pipe_warm = pipe.warm
        pipe.warm = lambda *b: warmed.append(b) or pipe_warm(*b)
        return pipe
    monkeypatch.setattr(serve, 'build_pipeline', build)
    frames = np.random.RandomState(4).uniform(0, 255, (4, 20, 16, 3)) \
        .astype(np.uint8)
    monkeypatch.setattr(serve, 'load_video', lambda path: (frames, 8.0))
    outputs = {}

    def save(out, save_dir, name, fps=8.0):
        outputs[name] = out
        return os.path.join(save_dir, name)
    monkeypatch.setattr(serve, 'save_video', save)
    qdir, sdir = tmp_path / 'q', tmp_path / 'out'
    qdir.mkdir()
    (qdir / 'a.json').write_text(json.dumps(
        {'input_path': 'in.mp4', 'prompt': 'a dog', 'seed': 9}))
    run_until_done(lambda: serve.main([
        '--queue_dir', str(qdir), '--save_dir', str(sdir), '--model_path',
        str(tmp_path / 'none'), '--allow_random_weights', '--solver_mode',
        'normal', '--steps', '2', '--warm', '4x20x16', '--poll_secs', '0.01',
        '--device', 'cpu']), qdir, ('a',), timeout=120)
    assert warmed == [(4, 20, 16)]
    res = json.loads((qdir / 'a.done.json').read_text())
    assert res['ok'], res
    assert res['output'] == str(sdir / 'in.mp4')
    pipe = build_pipeline(tiny_star_models(dtype=torch.bfloat16), TINY_CFG(
        sampler=SamplerConfig(steps=2, solver_mode='normal')),
        param_dtype=torch.bfloat16, allow_hash_tokenizer=True, device='cpu')
    np.testing.assert_array_equal(outputs['in.mp4'],
                                  pipe.enhance_a_video(frames, 'a dog', 9))


# -------------------------------------------------- profiling, warm_cache

def test_step_timer_matches_star_tpu():
    import jax
    import jax.numpy as jnp
    from star_tpu.utils.profiling import StepTimer as JaxStepTimer
    jt = JaxStepTimer()
    jt.timed('double', jax.jit(lambda x: x * 2), jnp.ones((4,)), warmup=1,
             iters=3)
    t = profiling.StepTimer()
    out = t.timed('double', lambda x: x * 2, torch.ones(4), warmup=1,
                  iters=3)
    assert torch.equal(out, torch.full((4,), 2.0))
    s = t.summary()
    assert s.keys() == jt.summary().keys() == {'double'} and s['double'] > 0
    assert len(t.times['double']) == len(jt.times['double']) == 3
    with t.measure('block'):
        time.sleep(0.01)
    assert t.summary()['block'] >= 0.01


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'tr')):
        with profiling.annotate('double_region'):
            y = torch.ones(64) * 2
        profiling.sync(y)
    trace = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'double_region' in names


def test_sync_finds_the_first_tensor():
    assert profiling._first_tensor({'a': [1, (torch.ones(1), 2)]}) \
        is not None
    assert profiling._first_tensor([1, 'x']) is None
    profiling.sync({'a': [torch.ones(2)]})      # a CPU tensor: no wait
    profiling.sync(None)


def test_warm_cache_says_nvcc_is_missing(tmp_path, monkeypatch):
    """No kernel library built from these sources in the build directory,
    no nvcc on the PATH or in NVCC: the build raises and says so."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'kernels'))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.delenv('NVCC', raising=False)
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.fail('this test expects a machine without the CUDA toolkit')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        warm_cache.main(['--frames', '8,16', '--sizes', '180x320'])
