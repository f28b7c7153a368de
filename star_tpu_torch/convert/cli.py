"""Checkpoint conversion CLI (counterpart of star_tpu/convert/cli.py): a
reference torch checkpoint -> a flat state dict of the port module, in the
checkpoint's own dtype, written with torch.save. It reads the checkpoint
memory-mapped and runs on the host; convert/load.py puts the result on the
card.

    python -m star_tpu_torch.convert.cli unet light_deg.pt out/unet.pt
    python -m star_tpu_torch.convert.cli vae  svd_vae_state_dict.bin out/vae.pt
    python -m star_tpu_torch.convert.cli clip open_clip_pytorch_model.bin \
        out/clip.pt
    python -m star_tpu_torch.convert.cli t5   t5_xxl_state_dict.bin out/t5.pt
    python -m star_tpu_torch.convert.cli dit  cog_transformer.pt out/dit.pt \
        --merge-lora
    python -m star_tpu_torch.convert.cli causal_vae 3d-vae.pt \
        out/causal_vae.pt

Write the files of one model into one directory under these names
({kind}.pt): the serving CLIs' --model_path points at it.
"""

from __future__ import annotations

from argparse import ArgumentParser

from . import load
from .convert import convert_state_dict, load_params, save_params
from .tower_maps import merge_sat_lora


def main(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('kind', choices=load.KINDS)
    p.add_argument('src')
    p.add_argument('dst')
    p.add_argument('--merge-lora', action='store_true')
    p.add_argument('--num-layers', type=int, default=None)
    p.add_argument('--trust-pickle', action='store_true',
                   help='read SRC with torch.load(weights_only=False), as '
                   'the JAX converter does: this runs the code that the '
                   "file's pickle names, so pass it only for a file you "
                   'trust (the default refuses any object that is not a '
                   'tensor or a plain container)')
    args = p.parse_args(argv)

    sd = load_params(args.src, trust_pickle=args.trust_pickle)
    for key in ('state_dict', 'module', 'model'):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    if args.kind == 'dit' and args.merge_lora:
        sd = merge_sat_lora(sd)
    build, name_map = load.tower(args.kind, args.num_layers)
    out = convert_state_dict(sd, name_map, load.on_meta(build))
    save_params(args.dst, out)
    n = sum(v.numel() for v in out.values())
    print(f'converted {args.kind}: {n / 1e6:.1f}M params -> {args.dst}')


if __name__ == '__main__':
    main()
