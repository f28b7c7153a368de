"""One rank of the multi-process cases of tests/test_torch_parallel.py.

Started by that test's module fixture as

    OMP_NUM_THREADS=1 python tests/torch_parallel_worker.py RANK WORLD PORT DIR

it joins a gloo world over tcp://127.0.0.1:PORT, reads DIR/inputs.pt (the
models' state dicts and the inputs, made by the test from numpy seeds),
runs every case below in order (each builds its own Mesh, which every rank
must do in the same order) and writes its results to DIR/rank{RANK}.pt.
It imports the port and torch only: the test holds the results to JAX.

    python tests/torch_parallel_worker.py cli sr|cog FLAGS...

runs train_sr.main or train_cog.main on the tiny towers of the CLI tests
(tests/test_torch_train_cli.py), as one process of a torchrun world given
by RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (or as one process).
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

from star_tpu_torch.parallel import (Mesh, shard_opt_state, shard_params,
                                     opt_state_memory_bytes)
from star_tpu_torch.parallel.context_parallel import (cp_causal_conv3d,
                                                      cp_group_norm)
from star_tpu_torch.parallel.mesh import AXIS_DATA, all_reduce, data_rows
from star_tpu_torch.parallel.ulysses import ulysses_attention_global

MESHES = ((2, 2, 1), (1, 1, 4), (4, 1, 1), (1, 2, 2))
# tests/test_train_cli.py's TinyControlled, one res block a level
UNET_KW = dict(dim=32, dim_mult=(1, 2), num_res_blocks=1, head_dim=16,
               num_heads_init_temporal=2, context_dim=32,
               attn_scales=(1.0, 0.5))
DIT_KW = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=2,
              latent_channels=4, text_hidden_size=32, text_length=8,
              time_embed_dim=16)


def case_mesh(inp):
    out = {}
    for shape in MESHES:
        m = Mesh(*shape)
        out[shape] = dict(coords=None if m.coords is None else
                          tuple(int(m.coords[a]) for a in
                                ('data', 'tensor', 'context')),
                          groups=dict(m.group_ranks))
    return out


def case_ulysses(inp):
    mesh = Mesh(1, 1, 4)
    return {name: ulysses_attention_global(q, k, v, mesh, kv_valid=kv)
            for name, (q, k, v, kv) in inp['ulysses'].items()}


def case_cp_prims(inp):
    mesh = Mesh(1, 1, 4)
    x, weight, bias, scale, gbias = inp['cp_prims']
    t = x.shape[1] // 4
    r = mesh.index('context')
    xl = x[:, r * t:(r + 1) * t]
    return dict(conv=cp_causal_conv3d(xl, weight, bias, mesh),
                norm=cp_group_norm(xl, scale, gbias, mesh, 32, 1e-6))


def case_zero(inp):
    from star_tpu_torch.train import TrainConfig
    from star_tpu_torch.train.trainer import Optimizer
    mesh = Mesh(4, 1, 1)
    params = {'w': inp['zero']['w'].clone(), 'b': inp['zero']['b'].clone()}
    tx = shard_opt_state(Optimizer(TrainConfig(), params), mesh)
    tx.update(inp['zero']['grads'], 0)
    parts = {n: tuple(p.shape) for n, p in
             zip(tx.names, tx.adamw.param_groups[0]['params'])}
    moments = {n: tuple(tx.adamw.state[p]['exp_avg'].shape) for n, p in
               zip(tx.names, tx.adamw.param_groups[0]['params'])}
    return dict(parts=parts, moments=moments, masters=params,
                bytes=opt_state_memory_bytes(tx), full=tx.full_state_dict())


def _unet(inp, mesh):
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    m = ControlledV2VUNet(**UNET_KW)
    m.load_state_dict(inp['unet'])
    return shard_params(m, mesh)


def case_tp_unet(inp):
    mesh = Mesh(2, 2, 1)
    m = _unet(inp, mesh)
    x, t, y, hint = (data_rows(a, mesh) for a in inp['unet_args'])
    with torch.no_grad():
        out = m(x, t, y, hint)
    q = m.unet.enc_0_0_spatial.block.attn1.to_q.weight
    return dict(out=out, data=mesh.index('data'),
                to_q=tuple(q.shape), plan=dict(m.tp_plan))


def _step_results(state, tx, metrics):
    return dict(masters={n: tx.full(n, p) for n, p in state.params.items()},
                ema={n: tx.full(n, p) for n, p in state.ema_params.items()},
                opt=tx.full_state_dict(),
                metrics={k: float(v) for k, v in metrics.items()})


def case_train_sr(inp):
    from star_tpu_torch.diffusion import (DiffusionTables,
                                          default_star_schedule)
    from star_tpu_torch.train import (TrainConfig, make_train_state,
                                      make_train_step)
    mesh = Mesh(2, 2, 1)
    m = _unet(inp, mesh)
    cfg = TrainConfig(freq_loss=False, ema_decay=0.999)
    state, tx = make_train_state(cfg, m)
    shard_opt_state(tx, mesh)
    step = make_train_step(cfg, m, DiffusionTables.from_schedule(
        default_star_schedule()), tx, mesh=mesh)
    b = inp['sr_batch']
    batch = {k: data_rows(v, mesh) for k, v in b['batch'].items()}
    state, metrics = step(state, batch, t=data_rows(b['t'], mesh),
                          noise=data_rows(b['noise'], mesh))
    return _step_results(state, tx, metrics)


def case_train_cog(inp):
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                                  make_cog_train_state,
                                                  make_cog_train_step)
    mesh = Mesh(2, 2, 1)
    dit = CogVideoDiT(lora_rank=4, **DIT_KW)
    dit.load_state_dict(inp['dit_lora'])
    shard_params(dit, mesh)
    cfg = CogTrainConfig(freq_loss=False, ema_decay=0.999)
    state, tx = make_cog_train_state(cfg, dit)
    shard_opt_state(tx, mesh)
    step = make_cog_train_step(cfg, dit, tx, mesh=mesh)
    b = inp['cog_batch']
    batch = {k: data_rows(v, mesh) for k, v in b['batch'].items()}
    state, metrics = step(state, batch, idx=data_rows(b['idx'], mesh),
                          noise=data_rows(b['noise'], mesh))
    return _step_results(state, tx, metrics)


def case_chunks(inp):
    from star_tpu_torch.pipeline.chunking import chunked_x0_fn
    mesh = Mesh(2, 1, 1)
    if mesh.coords is None:
        return None
    xt, hint, inds = inp['chunks']
    seen = []

    def denoise(x, h, t):
        seen.append(x.shape[0])
        return x * 0.5 + h * t

    out = chunked_x0_fn(denoise, hint, inds, mesh=mesh)(xt, 3)
    return dict(out=out, seen=seen)


def case_cp_vae(inp):
    from star_tpu_torch.vae.causal_vae import (CogVideoVAE, cp_decode,
                                               cp_encode)
    mesh = Mesh(1, 1, 2)
    if mesh.coords is None:
        return None
    vae = CogVideoVAE(**inp['vae_kw'])
    vae.load_state_dict(inp['vae'])
    video, z = inp['vae_args']
    with torch.no_grad():
        return dict(encode=cp_encode(vae, video, mesh),
                    decode=cp_decode(vae, z, mesh))


def case_dit_sp(inp):
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    out = {}
    for n in (2, 4):
        mesh = Mesh(1, 1, n)
        if mesh.coords is None:
            continue
        dit = CogVideoDiT(sp_group=mesh, **DIT_KW)
        dit.load_state_dict(inp['dit'])
        with torch.no_grad():
            out[n] = dit(*inp['dit_args'])
    return out


def case_failures(inp):
    """A tensor the backend does not take, and a collective on a group
    that is gone, raise: nothing falls back."""
    mesh = Mesh(4, 1, 1)
    got = {}
    try:
        all_reduce(torch.zeros(2, device='meta'), mesh, AXIS_DATA)
        got['meta'] = 'returned'
    except ValueError as e:
        got['meta'] = str(e)
    dist.destroy_process_group(mesh.group(AXIS_DATA))
    try:
        all_reduce(torch.zeros(2), mesh, AXIS_DATA)
        got['destroyed'] = 'returned'
    except Exception as e:          # the test reads what was raised
        got['destroyed'] = type(e).__name__
    return got


CASES = [case_mesh, case_ulysses, case_cp_prims, case_zero, case_tp_unet,
         case_train_sr, case_train_cog, case_chunks, case_cp_vae,
         case_dit_sp, case_failures]


def cog_towers(lora_rank):
    """train_cog's towers cut to tiny widths (the hash tokenizer gives 226
    ids below T5's 32128)."""
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.models.t5.encoder import T5Encoder
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    return {'dit': lambda: CogVideoDiT(
                hidden_size=64, num_layers=2, num_heads=1, patch_size=2,
                latent_channels=4, text_hidden_size=32, text_length=226,
                time_embed_dim=16, lora_rank=lora_rank),
            'causal_vae': lambda: CogVideoVAE(ch=32, ch_mult=(1, 1, 1, 1),
                                              num_res_blocks=1,
                                              z_channels=4),
            't5': lambda: T5Encoder(d_model=32, d_ff=48, num_heads=2,
                                    num_layers=1)}


def cli(kind: str, argv: list) -> None:
    torch.set_num_threads(1)
    if kind == 'sr':
        from star_tpu_torch.cli import train_sr
        from test_torch_cli import tiny_star_models
        train_sr.init_random_models = tiny_star_models
        train_sr.main(argv)
    else:
        from star_tpu_torch.cli import train_cog
        train_cog.towers = cog_towers
        train_cog.main(argv)


def main(rank: int, world: int, port: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    inp = torch.load(os.path.join(work, 'inputs.pt'), weights_only=False)
    out = {}
    for case in CASES:
        out[case.__name__[5:]] = case(inp)
    torch.save(out, os.path.join(work, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    if sys.argv[1] == 'cli':
        cli(sys.argv[2], sys.argv[3:])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4])
