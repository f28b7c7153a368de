"""The control of a cell's comparison: the plain reference put in the
program's place in the float8 control precision (reference/prims.py),
compared with the float32 reference exactly as a run compares the
program's output. Its readings set the upper end of each limit (PERF.md).

    python3 benchmark/control.py --workload i2vgen_sr_8f --seeds 1 2 3 \
        [--out control.jsonl] [--program]

Not part of a benchmark run; it needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sr_clips_readings(cfg, tr, seed, device, clips_in_window=5,
                      fp8=True):
    """(control numbers, seconds) of one seed of an sr_clips cell: the
    clip a run with `clips_in_window` saved clips would check."""
    import numpy as np
    import torch
    from benchmark.drivers import sr_clips
    from benchmark.harness import common, inputs
    from benchmark.harness.weights import to_float32
    from benchmark.reference import prims, sr_pipeline

    f, h, w = tr['frames'], tr['height'], tr['width']
    caps = inputs.captions(seed, tr['captions'], tr['caption_words'])
    pipe, sd = sr_clips.build(cfg, seed, device)
    del pipe
    sd32 = to_float32(sd)
    del sd
    common.free(device)
    pick = int(np.random.default_rng([seed, 3]).integers(clips_in_window))
    pl = cfg['pipeline']
    tok = inputs.WordHashTokenizer(cfg['text']['context_length'],
                                   cfg['text']['vocab_size'])
    cond = torch.as_tensor(tok([caps[pick % len(caps)]
                                + pl['positive_prompt']]), device=device)
    uncond = torch.as_tensor(tok([pl['negative_prompt']]), device=device)
    gh, gw = pl['pad_grid']
    noise = sr_clips.draw_noise(
        device, seed % (1 << 63),
        (1, f, gh // 8, gw // 8, cfg['vae']['latent_channels']),
        sr_pipeline.sde_steps(cfg['sampler']['steps']))
    frames = torch.as_tensor(inputs.clip_frames(seed, pick, f, h, w),
                             device=device)
    prims.set_fp32_matmul()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = sr_pipeline.enhance(prims.FP32, sd32, cfg, frames, cond,
                                  uncond, noise)
        t1 = time.perf_counter()
        ctl = sr_pipeline.enhance(prims.Precision(fp8=fp8), sd32, cfg,
                                  frames, cond, uncond, noise)
    t2 = time.perf_counter()
    served = torch.round(ctl).clamp(0, 255).to(torch.uint8).cpu().numpy()
    return sr_clips.compare(served, ref), {'reference_s': t1 - t0,
                                           'control_s': t2 - t1}


def program_readings(cfg, tr, seed, device):
    """(the program's numbers, the float32 reference's run) of one seed of
    a lora_train cell: a run's set-up steps and a window of one step, as
    run.py makes them."""
    from benchmark.drivers import lora_train
    from benchmark.harness import cell
    from benchmark.harness.work import LaunchLog
    out = lora_train.run({
        'config': cfg, 'traffic': tr, 'device': device, 'seed': seed,
        'seconds': 0.0, 'trace': False, 't_process': time.time(),
        'launch_log': LaunchLog(), 'profile': cell._no_profile})
    return out['numbers'], out['compared'][1]


def lora_train_readings(cfg, tr, seed, device, fp8=True, program=False):
    """(control numbers, seconds) of one seed of a lora_train cell: the
    reference's three steps in the control precision against the float32
    reference's, compared as a run compares the program's; with the
    reading of a fault planted in the float32 reference put in the
    program's place: the first LoRA leaf's update doubled, as the CPU
    test plants it in the program (`fault_doubled.*`). With `program` the
    program's own numbers too (`program.*`), against the same float32
    reference."""
    import torch
    from benchmark.drivers import lora_train
    from benchmark.harness import common, inputs
    from benchmark.reference import prims

    rows = inputs.video_pairs(seed, tr['pool'], tr['frames'], tr['height'],
                              tr['width'], device)[:lora_train.FIRST_STEPS]
    lat = (1, (tr['frames'] - 1) // 4 + 1, tr['height'] // 8,
           tr['width'] // 8, cfg['vae']['z_channels'])
    runs, secs, prog = {}, {}, {}
    todo = [('reference', prims.FP32), ('control', prims.Precision(fp8=fp8))]
    if program:
        t0 = time.perf_counter()
        prog, runs['reference'] = program_readings(cfg, tr, seed, device)
        secs['program_and_reference_s'] = time.perf_counter() - t0
        todo = todo[1:]
        common.free(device)
    for name, prec in todo:
        models, sd = lora_train.build(cfg, seed, device, torch.bfloat16)
        first = next(n for n, _ in models.dit.named_parameters()
                     if 'lora_' in n)
        del models
        common.free(device)
        prims.set_fp32_matmul()
        t0 = time.perf_counter()
        runs[name] = lora_train.reference_three_steps(
            prec, sd, cfg, rows, seed, device, lat)
        secs[name + '_s'] = time.perf_counter() - t0
        del sd
        common.free(device)
    ref = runs['reference']
    out = lora_train.compare(runs['control'], ref)
    doubled = dict(ref, delta3={**ref['delta3'],
                                first: 2.0 * ref['delta3'][first]})
    out.update({f'fault_doubled.{k}': v for k, v in
                lora_train.compare(doubled, ref).items()})
    out.update({f'program.{k}': v for k, v in prog.items()})
    return out, secs


def main(argv=None):
    import torch
    from benchmark.harness import common
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out', default=None)
    p.add_argument('--program', action='store_true',
                   help='lora_train: read the program against the same '
                        'reference too')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('the control runs on a CUDA card')
    bench = common.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    _, centry, tr = common.find_cell(bench, args.workload)
    cfg = common.load_json(os.path.join(ROOT, centry['file']))
    dev = torch.device('cuda', 0)
    for seed in args.seeds:
        if tr['kind'] == 'lora_train':
            numbers, secs = lora_train_readings(cfg, tr, seed, dev,
                                                program=args.program)
        else:
            numbers, secs = sr_clips_readings(cfg, tr, seed, dev)
        line = json.dumps({'workload': args.workload, 'seed': seed,
                           'control': numbers, **secs,
                           'card': torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
            with open(args.out, 'a') as f:
                f.write(line + '\n')
        common.free(dev)


if __name__ == '__main__':
    main()
