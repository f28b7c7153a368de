"""star_tpu_torch/parallel/ and its consumers against star_tpu on the CPU.

One module-scoped spawn of 4 gloo ranks (tests/torch_parallel_worker.py,
which imports neither jax nor star_tpu, one torch thread a rank) runs
every multi-rank case while this process computes the JAX references;
each check below is its own case:

  * the mesh's rank layout against make_mesh's device ids;
  * param_specs of the tiny UNet+ControlNet and DiT against JAX's
    spec_for_path, name by name, and the storage plan's replicated layers;
  * ulysses_attention at context 4 against star_tpu's on conftest's 8 CPU
    devices, with an indivisible sequence and kv_valid;
  * cp_causal_conv3d and cp_group_norm at context 4 against star_tpu's;
  * ZeRO part shapes (tests/test_aux.py:32) and the ZeRO update against
    the replicated one;
  * the TP UNet+ControlNet forward at data 2 x tensor 2 against JAX's
    unsharded apply at JAX's own tolerance (tests/test_train_cli.py:56-81);
  * the DP2 x TP2 I2VGen and Cog train steps against the single-process
    step at the global batch: masters, moments and EMA within 1e-5;
  * the chunk windows over data 2;
  * cp_encode / cp_decode at context 2 and the DiT under SP at context 2
    and 4, against the port's serial modules (which
    test_torch_causal_vae.py and test_torch_dit.py hold to JAX).
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.parallel import param_specs, spec_for_path
from star_tpu_torch.parallel.sharding import tp_plan
from test_torch_harness import port, randn, random_params, rng, t
import torch_parallel_worker as W

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
WORLD = 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _unet_params():
    from star_tpu.models.unet.unet import ControlledV2VUNet as JUNet
    jm = JUNet(**W.UNET_KW)
    z = jnp.zeros((1, 2, 10, 8, 4))
    return jm, random_params(jm, z, jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 7, 32)), z, seed=3)


def _inputs():
    """The workers' inputs, from numpy seeds and the JAX trees."""
    r = rng(20)
    jm, uparams = _unet_params()
    unet = port(ControlledV2VUNet(**W.UNET_KW), uparams)
    x = randn(r, 2, 2, 10, 8, 4)
    unet_args = (t(x), torch.tensor([3, 7]), t(randn(r, 2, 7, 32)),
                 t(randn(r, 2, 2, 10, 8, 4)))
    torch.manual_seed(0)
    dit_lora = CogVideoDiT(lora_rank=4, **W.DIT_KW)
    dit = CogVideoDiT(**W.DIT_KW)
    with torch.no_grad():
        for m in (dit_lora, dit):       # no zero-init layer stays zero
            for p in m.parameters():
                p.add_(torch.randn(p.shape) * 0.05)
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    vae_kw = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                  z_channels=4)
    vae = CogVideoVAE(**vae_kw)
    ul = {}
    for name, s, h, kv in (('divisible', 64, 8, None),
                           ('indivisible', 61, 4, None),
                           ('kv_valid', 64, 8, 57)):
        ul[name] = tuple(t(randn(r, 2, s, h, 16)) for _ in range(3)) + (kv,)
    return dict(
        unet=unet.state_dict(), unet_args=unet_args,
        ulysses=ul,
        cp_prims=(t(randn(r, 1, 8, 6, 5, 32)),
                  t(randn(r, 16, 32, 3, 3, 3, scale=0.1)),
                  t(randn(r, 16, scale=0.1)),
                  t(1 + randn(r, 32, scale=0.1)), t(randn(r, 32, scale=0.1))),
        zero=dict(w=t(randn(r, 16, 24)), b=t(randn(r, 3)),
                  grads={'w': t(randn(r, 16, 24)), 'b': t(randn(r, 3))}),
        sr_batch=dict(batch={'gt_latent': t(randn(r, 2, 2, 10, 8, 4)),
                             'lq_latent': t(randn(r, 2, 2, 10, 8, 4)),
                             'y': t(randn(r, 2, 7, 32))},
                      t=torch.tensor([120, 870]),
                      noise=t(randn(r, 2, 2, 10, 8, 4))),
        dit_lora=dit_lora.state_dict(), dit=dit.state_dict(),
        cog_batch=dict(batch={'gt_latent': t(randn(r, 2, 2, 8, 8, 4)),
                              'lq_latent': t(randn(r, 2, 2, 8, 8, 4)),
                              'y': t(randn(r, 2, 8, 32))},
                       idx=torch.tensor([300, 40]),
                       noise=t(randn(r, 2, 2, 8, 8, 4))),
        dit_args=(t(randn(r, 1, 3, 8, 8, 8)), torch.tensor([5]),
                  t(randn(r, 1, 8, 32))),
        chunks=(t(randn(r, 1, 20, 4, 4, 2)), t(randn(r, 1, 20, 4, 4, 2)),
                [(0, 8), (4, 12), (8, 16), (12, 20)]),
        vae=vae.state_dict(), vae_kw=vae_kw,
        vae_args=(t(randn(r, 1, 17, 16, 16, 3)), t(randn(r, 1, 5, 4, 4, 4))),
    ), jm, uparams


class Ranks:
    def __init__(self, work):
        self.work = work
        self.inputs, self.jm, self.uparams = _inputs()
        torch.save(self.inputs, os.path.join(work, 'inputs.pt'))
        port_ = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS='1',
                   PYTHONPATH=os.pathsep.join(
                       [ROOT, os.path.join(ROOT, 'tests'),
                        os.environ.get('PYTHONPATH', '')]))
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, 'tests',
                                          'torch_parallel_worker.py'),
             str(r), str(WORLD), str(port_), work], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self._out = None
        self.ref = self._references()

    def _references(self):
        """The JAX results, computed while the ranks run."""
        from star_tpu.parallel import make_mesh
        from star_tpu.parallel.context_parallel import (cp_causal_conv3d,
                                                        cp_group_norm)
        from star_tpu.parallel.ulysses import ulysses_attention
        inp, ref = self.inputs, {}
        x, tt, y, hint = (a.numpy() for a in inp['unet_args'])
        ref['unet'] = np.asarray(jax.jit(self.jm.apply)(self.uparams, x, tt,
                                                        y, hint))
        mesh = make_mesh(context=4)
        with mesh:
            for case, (q, k, v, kv) in inp['ulysses'].items():
                ref[case] = jax.jit(lambda a, b, c: ulysses_attention(
                    a, b, c, mesh, kv_valid=kv))(
                        *(jnp.asarray(z.numpy()) for z in (q, k, v)))
            xc, weight, bias, scale, gbias = (np.asarray(a) for a in
                                              inp['cp_prims'])
            ref['conv'] = cp_causal_conv3d(
                xc, weight.transpose(2, 3, 4, 1, 0), bias, mesh)
            ref['norm'] = cp_group_norm(xc, scale, gbias, mesh, 32, 1e-6)
        return ref

    def results(self):
        """Every rank's results (waits for the ranks)."""
        if self._out is None:
            logs = [p.communicate(timeout=300)[0].decode() for p in
                    self.procs]
            codes = [p.returncode for p in self.procs]
            assert codes == [0] * WORLD, '\n'.join(logs)[-4000:]
            self._out = [torch.load(os.path.join(self.work, f'rank{r}.pt'),
                                    weights_only=False)
                         for r in range(WORLD)]
        return self._out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, eight_devices):
    rk = Ranks(str(tmp_path_factory.mktemp('ranks')))
    yield rk
    for p in rk.procs:
        if p.poll() is None:
            p.kill()


def _close(got, want, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------------- layout


@pytest.mark.parametrize('shape', W.MESHES)
def test_mesh_layout_matches_make_mesh(ranks, eight_devices, shape):
    from star_tpu.parallel import make_mesh
    ids = np.vectorize(lambda d: d.id)(make_mesh(*shape).devices)
    for r, out in enumerate(ranks.results()):
        got = out['mesh'][shape]
        where = np.argwhere(ids == r)
        if not len(where):
            assert got['coords'] is None
            continue
        assert got['coords'] == tuple(where[0])
        for i, axis in enumerate(('data', 'tensor', 'context')):
            idx = list(where[0])
            idx[i] = slice(None)
            assert got['groups'][axis] == [int(v) for v in ids[tuple(idx)]]


def test_every_public_name_of_star_tpu_parallel_has_its_counterpart():
    import ast
    import star_tpu_torch.parallel as ours
    src = open(os.path.join(ROOT, 'star_tpu', 'parallel', '__init__.py'))
    names = [a.asname or a.name for node in ast.walk(ast.parse(src.read()))
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) == 18
    assert [n for n in names if not hasattr(ours, n)] == []


def _flax_names(module, tree):
    """Port parameter name -> flax path of the leaf it came from (each
    leaf filled with its index, through convert/from_flax.py)."""
    from star_tpu_torch.convert import from_flax
    flat = jax.tree_util.tree_leaves_with_path(tree)
    paths = ['/'.join(str(k.key) for k in p) for p, _ in flat]
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.full(v.shape, i, np.float32) for i, (_, v) in enumerate(flat)])
    sd = from_flax(module, ids)
    return {n: paths[int(v.reshape(-1)[0])] for n, v in sd.items()}


@pytest.mark.parametrize('tower', ['unet', 'dit'])
def test_param_specs_match_spec_for_path(tower):
    """Every parameter's spec is JAX's spec of the flax path it converts
    from (stacked DiT layers: the spec without its leading layer axis)."""
    from star_tpu.parallel import param_specs as jparam_specs
    from star_tpu.parallel import spec_for_path as jspec
    if tower == 'unet':
        jm, tree = _unet_params()
        ours = ControlledV2VUNet(**W.UNET_KW)
    else:
        from star_tpu.models.dit.dit import CogVideoDiT as JDiT
        jm = JDiT(lora_rank=4, **W.DIT_KW)
        tree = random_params(jm, jnp.zeros((1, 2, 8, 8, 8)),
                             jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 8, 32)))
        ours = CogVideoDiT(lora_rank=4, **W.DIT_KW)
    names = _flax_names(ours, tree['params'])
    jspecs = dict(zip(
        ['/'.join(str(k.key) for k in p) for p, _ in
         jax.tree_util.tree_leaves_with_path(tree['params'])],
        jax.tree_util.tree_leaves(jparam_specs(tree['params']),
                                  is_leaf=lambda x: isinstance(
                                      x, jax.sharding.PartitionSpec))))
    specs = param_specs(ours)
    assert set(specs) == set(names)
    sharded = 0
    for n, path in names.items():
        want = tuple(jspecs[path])
        if 'layers/layer/' in path and want:
            want = want[1:]             # the scan's layer axis
        assert tuple(specs[n]) == want == tuple(jspec(path)), (n, path)
        assert tuple(spec_for_path(path)) == tuple(jspec(path))
        sharded += bool(want)
    assert sharded > 10


def test_storage_plan_keeps_indivisible_heads_replicated():
    """At tensor 4 the tiny UNet's level-0 and init temporal attentions
    (2 heads) stay whole, out projections with them; the 4-head level-1
    ones and every GEGLU are split. The DiT's LoRA layout: qkv lora_a
    whole, lora_b split; dense lora_a split, lora_b whole."""
    m = ControlledV2VUNet(**W.UNET_KW)
    specs = param_specs(m, tensor=4)
    lv0 = 'unet.enc_0_0_spatial.block.attn1'
    lv1 = 'unet.enc_1_0_spatial.block.attn1'
    assert specs[f'{lv0}.to_q.weight'] == () == specs[f'{lv0}.to_out.weight']
    assert specs[f'{lv1}.to_q.weight'] == (None, 'tensor')
    assert specs[f'{lv1}.to_out.weight'] == ('tensor', None)
    assert specs['unet.enc_0_0_spatial.block.ff.proj.weight'] == \
        (None, 'tensor')
    init = 'unet.init_temporal.block.attn1.to_q.weight'   # 2 heads
    assert specs[init] == () and \
        param_specs(m, tensor=2)[init] == (None, 'tensor')
    d = param_specs(CogVideoDiT(lora_rank=4, **W.DIT_KW), tensor=2)
    assert d['layers.0.qkv.lora_a.weight'] == ()
    assert d['layers.0.qkv.lora_b.weight'] == (None, 'tensor')
    assert d['layers.0.dense.lora_a.weight'] == ('tensor', None)
    assert d['layers.0.dense.lora_b.weight'] == ()
    assert tp_plan(CogVideoDiT(**W.DIT_KW), 3) == {}


def test_kernel_launch_plans_take_local_heads():
    """Local heads reach K1 as [B, S, (H/P)*64]: its launch plan takes
    the DiT's 24 of 48 heads and the UNet's 5 and 10."""
    from star_tpu_torch.ops.flash_attention import k1_launch_plan
    for heads in (24, 10, 5):
        plan = k1_launch_plan(2, heads, 9680, 9680, 9676, 64)
        assert plan['grid'][1] == 2 * heads


# ---------------------------------------------------- collectives vs JAX


@pytest.mark.parametrize('case', ['divisible', 'indivisible', 'kv_valid'])
def test_ulysses_matches_star_tpu(ranks, case):
    for out in ranks.results():
        _close(out['ulysses'][case], ranks.ref[case])


@pytest.mark.parametrize('prim', ['conv', 'norm'])
def test_cp_primitives_match_star_tpu(ranks, prim):
    got = torch.cat([out['cp_prims'][prim] for out in ranks.results()], 1)
    _close(got, ranks.ref[prim], atol=1e-4)


def test_zero_part_shapes():
    """tests/test_aux.py:32 at data 8: w (16, 24) split along its first
    dim to (2, 24), b (3,) kept whole."""
    import types
    from star_tpu_torch.parallel.zero import _shardable_axis, zero_part
    mesh = types.SimpleNamespace(size=lambda a: 8, index=lambda a: 5)
    w, b = torch.zeros(16, 24), torch.zeros(3)
    assert zero_part(w, _shardable_axis(w.shape, 8), mesh).shape == (2, 24)
    assert zero_part(b, _shardable_axis(b.shape, 8), mesh).shape == (3,)


def test_zero_update_equals_the_replicated_one(ranks):
    from star_tpu_torch.train import TrainConfig
    from star_tpu_torch.train.trainer import Optimizer
    z = ranks.inputs['zero']
    params = {'w': z['w'].clone(), 'b': z['b'].clone()}
    tx = Optimizer(TrainConfig(), params)
    tx.update(z['grads'], 0)
    full = tx.adamw.state_dict()['state']
    for out in ranks.results():
        got = out['zero']
        assert got['parts'] == {'w': (4, 24), 'b': (3,)} == got['moments']
        assert got['bytes'] == 4 * (2 * (4 * 24 + 3)) + 2 * 4
        for n in params:
            assert torch.equal(got['masters'][n], params[n]), n
        for i, st in full.items():
            for k, v in st.items():
                assert torch.equal(got['full']['state'][i][k], v), (i, k)


def test_tp_unet_forward_matches_star_tpu(ranks):
    """data 2 x tensor 2: each data rank's rows against JAX's unsharded
    apply (atol 2e-5, rtol 1e-4); the level-1 to_q holds half its
    columns; tensor ranks agree."""
    want = ranks.ref['unet']
    outs = ranks.results()
    for r, out in enumerate(outs):
        got = out['tp_unet']
        d = got['data']
        np.testing.assert_allclose(got['out'].numpy(), want[d:d + 1],
                                   atol=2e-5, rtol=1e-4)
        assert got['to_q'] == (16, 32)      # 2 heads of 16 -> 1 a rank
        assert 'unet.enc_1_0_temporal.block.ff.proj.weight' in got['plan']


def _single_process(kind, inp):
    from star_tpu_torch.diffusion import (DiffusionTables,
                                          default_star_schedule)
    from star_tpu_torch.train import (TrainConfig, make_train_state,
                                      make_train_step)
    from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                                  make_cog_train_state,
                                                  make_cog_train_step)
    if kind == 'sr':
        m = ControlledV2VUNet(**W.UNET_KW)
        m.load_state_dict(inp['unet'])
        cfg = TrainConfig(freq_loss=False, ema_decay=0.999)
        state, tx = make_train_state(cfg, m)
        step = make_train_step(cfg, m, DiffusionTables.from_schedule(
            default_star_schedule()), tx)
        b = inp['sr_batch']
        state, metrics = step(state, b['batch'], t=b['t'], noise=b['noise'])
    else:
        m = CogVideoDiT(lora_rank=4, **W.DIT_KW)
        m.load_state_dict(inp['dit_lora'])
        cfg = CogTrainConfig(freq_loss=False, ema_decay=0.999)
        state, tx = make_cog_train_state(cfg, m)
        step = make_cog_train_step(cfg, m, tx)
        b = inp['cog_batch']
        state, metrics = step(state, b['batch'], idx=b['idx'],
                              noise=b['noise'])
    return state, tx, metrics


@pytest.mark.parametrize('kind', ['sr', 'cog'])
def test_train_step_dp2_tp2_matches_single_process(ranks, kind):
    """One step (gradients, clip, AdamW with ZeRO-1 moments, EMA) at
    data 2 x tensor 2 against one process at the global batch of 2:
    masters, moments and EMA within 1e-5, the metrics within 1e-5 of
    their size."""
    state, tx, metrics = _single_process(kind, ranks.inputs)
    opt = tx.adamw.state_dict()['state']
    moved = 0
    for out in ranks.results():
        got = out[f'train_{kind}']
        assert set(got['masters']) == set(state.params)
        for n, p in state.params.items():
            _close(got['masters'][n], p)
            _close(got['ema'][n], state.ema_params[n])
            moved += int(not torch.equal(p, tx.masters[n]))
        for i, st in opt.items():
            for k in ('exp_avg', 'exp_avg_sq'):
                _close(got['opt']['state'][i][k], st[k])
        for k, v in metrics.items():
            assert got['metrics'][k] == pytest.approx(float(v), rel=TOL), k


def test_chunk_windows_split_over_data(ranks):
    """Four 8-frame windows fold into a batch of 4, two a data rank; the
    stitched x0 equals the one-process result bit for bit."""
    from star_tpu_torch.pipeline.chunking import chunked_x0_fn
    xt, hint, inds = ranks.inputs['chunks']
    want = chunked_x0_fn(lambda x, h, tt: x * 0.5 + h * tt, hint, inds)(
        xt, 3)
    outs = [o['chunks'] for o in ranks.results()]
    assert outs[2] is None and outs[3] is None
    for got in outs[:2]:
        assert got['seen'] == [2] and torch.equal(got['out'], want)


@pytest.mark.parametrize('what', ['encode', 'decode'])
def test_cp_vae_matches_the_serial_vae(ranks, what):
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    vae = CogVideoVAE(**ranks.inputs['vae_kw'])
    vae.load_state_dict(ranks.inputs['vae'])
    video, z = ranks.inputs['vae_args']
    with torch.no_grad():
        want = vae.encoder(video) if what == 'encode' else vae.decoder(z)
    for out in ranks.results()[:2]:
        got = out['cp_vae'][what]
        assert got.shape == want.shape
        _close(got, want, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize('n', [2, 4])
def test_dit_sp_matches_the_serial_dit(ranks, n):
    dit = CogVideoDiT(**W.DIT_KW)
    dit.load_state_dict(ranks.inputs['dit'])
    with torch.no_grad():
        want = dit(*ranks.inputs['dit_args'])
    for out in ranks.results()[:n]:
        _close(out['dit_sp'][n], want, atol=2e-5, rtol=1e-4)


def test_collective_refusals_raise(ranks):
    for out in ranks.results():
        got = out['failures']
        assert 'meta tensor handed to a gloo group' in got['meta']
        assert got['destroyed'] != 'returned'
