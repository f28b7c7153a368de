"""Name maps for the auxiliary towers: OpenCLIP text, SVD temporal VAE,
T5 encoder, CogVideoX DiT (SAT checkpoint naming)
(counterpart of star_tpu/convert/tower_maps.py).

Sources of the torch-side names:
  * OpenCLIP: open_clip's CLIP text tower (embedder.py:54-72 walks
    model.token_embedding/positional_embedding/transformer.resblocks/ln_final)
  * SVD VAE: diffusers AutoencoderKLTemporalDecoder module tree
    (video_to_video_model.py:57-63)
  * T5: HF T5EncoderModel (modules.py:234-281)
  * DiT: SAT BaseModel checkpoints (dit_video_concat.py mixins +
    transformer.layers.* from sat's TP transformer)
"""

from __future__ import annotations

import dataclasses
import re

import torch

from ..models.dit.dit import rope_head_perm
from .layout import as_vector, conv3d_t11_kernel
from .unet_map import NameMap, _wb


# --------------------------------------------------------------------- CLIP

def clip_text_name_map(layers: int = 24, penultimate: bool = True) -> NameMap:
    """open_clip packs qkv as in_proj_weight [3C, C], and so does the
    port's CLIPAttention: it is copied as it is. With `penultimate` the
    last block is not used (the reference embeds with the penultimate
    layer's output), nor are open_clip's image tower and contrastive head
    (embedder.py deletes model.visual)."""
    n_blocks = layers - (1 if penultimate else 0)
    m = NameMap(ignore=[rf'transformer\.resblocks\.{i}\..*'
                        for i in range(n_blocks, layers)]
                + [r'visual\..*', 'logit_scale', 'text_projection'])
    m['token_embedding'] = ('token_embedding.weight', None)
    m['positional_embedding'] = ('positional_embedding', None)
    for i in range(n_blocks):
        src = f'transformer.resblocks.{i}'
        dst = f'resblock_{i}'
        _wb(f'{dst}.ln_1', f'{src}.ln_1', m)
        m[f'{dst}.attn.in_proj.weight'] = (f'{src}.attn.in_proj_weight', None)
        m[f'{dst}.attn.in_proj.bias'] = (f'{src}.attn.in_proj_bias', None)
        _wb(f'{dst}.attn.out_proj', f'{src}.attn.out_proj', m)
        _wb(f'{dst}.ln_2', f'{src}.ln_2', m)
        _wb(f'{dst}.mlp_fc', f'{src}.mlp.c_fc', m)
        _wb(f'{dst}.mlp_proj', f'{src}.mlp.c_proj', m)
    _wb('ln_final', 'ln_final', m)
    return m


def hf_clip_text_to_open_clip_sd(sd: dict) -> dict:
    """Rename an HF CLIPTextModel state dict (laion/CLIP-ViT-H-14 is shipped
    in this format) to open_clip's text-tower naming so clip_text_name_map
    applies. HF stores q/k/v separately; open_clip packs them (q;k;v) into
    in_proj_weight/in_proj_bias."""
    out = {}
    pfx = 'text_model.'
    for k, v in sd.items():
        if not k.startswith(pfx):
            continue
        k = k[len(pfx):]
        if k == 'embeddings.token_embedding.weight':
            out['token_embedding.weight'] = v
        elif k == 'embeddings.position_embedding.weight':
            out['positional_embedding'] = v
        elif k.startswith('final_layer_norm.'):
            out['ln_final.' + k.split('.', 1)[1]] = v
        elif k.startswith('encoder.layers.'):
            _, _, i, rest = k.split('.', 3)
            dst = f'transformer.resblocks.{i}.'
            rest = (rest
                    .replace('layer_norm1.', 'ln_1.')
                    .replace('layer_norm2.', 'ln_2.')
                    .replace('mlp.fc1.', 'mlp.c_fc.')
                    .replace('mlp.fc2.', 'mlp.c_proj.')
                    .replace('self_attn.out_proj.', 'attn.out_proj.'))
            if rest.startswith('self_attn.'):
                continue  # q/k/v packed below
            out[dst + rest] = v
    layers = {int(mt.group(1)) for k in sd
              if (mt := re.match(r'text_model\.encoder\.layers\.(\d+)\.', k))}
    for i in sorted(layers):
        src = f'text_model.encoder.layers.{i}.self_attn.'
        dst = f'transformer.resblocks.{i}.attn.'
        for part in ('weight', 'bias'):
            out[dst + f'in_proj_{part}'] = torch.cat(
                [torch.as_tensor(sd[src + f'{p}_proj.{part}'])
                 for p in ('q', 'k', 'v')], dim=0)
    return out


# ------------------------------------------------------------------ SVD VAE

def _resnet2d(dst: str, src: str, m: NameMap, shortcut: bool):
    _wb(f'{dst}.norm1', f'{src}.norm1', m)
    _wb(f'{dst}.conv1', f'{src}.conv1', m)
    _wb(f'{dst}.norm2', f'{src}.norm2', m)
    _wb(f'{dst}.conv2', f'{src}.conv2', m)
    if shortcut:
        _wb(f'{dst}.conv_shortcut', f'{src}.conv_shortcut', m)


def _temporal_resnet(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.norm1', f'{src}.norm1', m)
    _wb(f'{dst}.conv1', f'{src}.conv1', m, fn=conv3d_t11_kernel)
    _wb(f'{dst}.norm2', f'{src}.norm2', m)
    _wb(f'{dst}.conv2', f'{src}.conv2', m, fn=conv3d_t11_kernel)


def _spatio_temporal(dst: str, src: str, m: NameMap, shortcut: bool = False):
    _resnet2d(f'{dst}.spatial_res_block', f'{src}.spatial_res_block', m,
              shortcut)
    _temporal_resnet(f'{dst}.temporal_res_block', f'{src}.temporal_res_block',
                     m)
    m[f'{dst}.mix_factor'] = (f'{src}.time_mixer.mix_factor', as_vector)


def _vae_attention(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.group_norm', f'{src}.group_norm', m)
    _wb(f'{dst}.to_q', f'{src}.to_q', m)
    _wb(f'{dst}.to_k', f'{src}.to_k', m)
    _wb(f'{dst}.to_v', f'{src}.to_v', m)
    _wb(f'{dst}.to_out', f'{src}.to_out.0', m)


def svd_vae_name_map(block_out_channels=(128, 256, 512, 512),
                     layers_per_block: int = 2) -> NameMap:
    m = NameMap()
    chs = list(block_out_channels)
    # encoder
    _wb('encoder.conv_in', 'encoder.conv_in', m)
    prev = chs[0]
    for i, ch in enumerate(chs):
        for j in range(layers_per_block):
            _resnet2d(f'encoder.down_{i}_res_{j}',
                      f'encoder.down_blocks.{i}.resnets.{j}', m,
                      shortcut=(prev if j == 0 else ch) != ch)
        prev = ch
        if i != len(chs) - 1:
            _wb(f'encoder.down_{i}_downsample',
                f'encoder.down_blocks.{i}.downsamplers.0.conv', m)
    _resnet2d('encoder.mid_res_1', 'encoder.mid_block.resnets.0', m, False)
    _vae_attention('encoder.mid_attn', 'encoder.mid_block.attentions.0', m)
    _resnet2d('encoder.mid_res_2', 'encoder.mid_block.resnets.1', m, False)
    _wb('encoder.conv_norm_out', 'encoder.conv_norm_out', m)
    _wb('encoder.conv_out', 'encoder.conv_out', m)
    _wb('encoder.quant_conv', 'quant_conv', m)

    # temporal decoder
    _wb('decoder.conv_in', 'decoder.conv_in', m)
    _spatio_temporal('decoder.mid_res_0', 'decoder.mid_block.resnets.0', m)
    _vae_attention('decoder.mid_attn', 'decoder.mid_block.attentions.0', m)
    _spatio_temporal('decoder.mid_res_1', 'decoder.mid_block.resnets.1', m)
    rchs = list(reversed(chs))
    prev = rchs[0]
    for i, ch in enumerate(rchs):
        for j in range(layers_per_block + 1):
            _spatio_temporal(f'decoder.up_{i}_res_{j}',
                             f'decoder.up_blocks.{i}.resnets.{j}', m,
                             shortcut=(prev if j == 0 else ch) != ch)
        prev = ch
        if i != len(rchs) - 1:
            _wb(f'decoder.up_{i}_upsample',
                f'decoder.up_blocks.{i}.upsamplers.0.conv', m)
    _wb('decoder.conv_norm_out', 'decoder.conv_norm_out', m)
    _wb('decoder.conv_out', 'decoder.conv_out', m)
    _wb('decoder.time_conv_out', 'decoder.time_conv_out', m,
        fn=conv3d_t11_kernel)
    return m


# ----------------------------------------------------------------------- T5

def t5_encoder_name_map(num_layers: int = 24) -> NameMap:
    """HF's T5EncoderModel also holds the input embedding tied to
    'shared' as encoder.embed_tokens; the port reads 'shared'."""
    m = NameMap(ignore=[r'encoder\.embed_tokens\.weight'])
    m['token_embedding'] = ('shared.weight', None)
    m['relative_attention_bias'] = (
        'encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight',
        None)
    for i in range(num_layers):
        src = f'encoder.block.{i}'
        dst = f'block_{i}'
        for p in ('q', 'k', 'v', 'o'):
            _wb(f'{dst}.{p}', f'{src}.layer.0.SelfAttention.{p}', m,
                bias=False)
        m[f'{dst}.ln_attn.scale'] = (f'{src}.layer.0.layer_norm.weight', None)
        for p in ('wi_0', 'wi_1', 'wo'):
            _wb(f'{dst}.{p}', f'{src}.layer.1.DenseReluDense.{p}', m,
                bias=False)
        m[f'{dst}.ln_mlp.scale'] = (f'{src}.layer.1.layer_norm.weight', None)
    m['final_norm.scale'] = ('encoder.final_layer_norm.weight', None)
    return m


# -------------------------------------------------------------- CogVideo DiT

@dataclasses.dataclass(frozen=True)
class HeadPerm:
    """Permute the head dims of q and k by `perm`: the rows of the packed
    qkv weight [3C, in] or bias [3C] (`packed`, C = num_heads * len(perm);
    the v rows stay), or a qk-LayerNorm parameter [head_dim]."""
    perm: tuple
    num_heads: int = 1
    packed: bool = False

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self.perm, device=t.device)
        if not self.packed:
            return t.index_select(0, idx)
        x = t.reshape(3, self.num_heads, len(self.perm), *t.shape[1:])
        return torch.cat([x[:2].index_select(2, idx), x[2:]]).reshape(t.shape)


def dit_name_map(num_layers: int = 42, num_heads: int = 48,
                 head_dim: int = 64) -> NameMap:
    """The DiT's layers land on the port's nn.ModuleList one by one (the
    JAX package stacks them for its scan). LoRA (SAT lora2) is merged into
    qkv/dense by merge_sat_lora() before this map is applied.

    The q/k rows of the packed qkv projection and the qk-LN parameters
    take the RoPE half-split head-dim permutation (dit.rope_head_perm): the
    port rotates halves instead of interleaved pairs; logits are invariant
    because q and k share the permutation. The reference's RoPE tables and
    learned position embeddings are not used (the port makes its own)."""
    perm = tuple(int(i) for i in rope_head_perm(head_dim))
    qkv = HeadPerm(perm, num_heads, packed=True)
    qk_ln = HeadPerm(perm)
    m = NameMap(ignore=[r'mixins\.pos_embed\.freqs_(cos|sin)',
                        r'transformer\.position_embeddings\.weight'])
    _wb('time_embed_1', 'time_embed.0', m)
    _wb('time_embed_2', 'time_embed.2', m)
    _wb('proj_sr', 'mixins.patch_embed.proj_sr', m)
    _wb('text_proj', 'mixins.patch_embed.text_proj', m)
    for i in range(num_layers):
        dst, src = f'layers.{i}', f'transformer.layers.{i}'
        ada = 'mixins.adaln_layer'
        _wb(f'{dst}.adaln', f'{ada}.adaLN_modulations.{i}.1', m)
        for name, lst in (('q_ln', 'query_layernorm_list'),
                          ('k_ln', 'key_layernorm_list')):
            m[f'{dst}.{name}_scale'] = (f'{ada}.{lst}.{i}.weight', qk_ln)
            m[f'{dst}.{name}_bias'] = (f'{ada}.{lst}.{i}.bias', qk_ln)
        for name, sname in (('input_ln', 'input_layernorm'),
                            ('post_ln', 'post_attention_layernorm')):
            m[f'{dst}.{name}_scale'] = (f'{src}.{sname}.weight', None)
            m[f'{dst}.{name}_bias'] = (f'{src}.{sname}.bias', None)
        m[f'{dst}.qkv.base.weight'] = (
            f'{src}.attention.query_key_value.weight', qkv)
        m[f'{dst}.qkv.base.bias'] = (
            f'{src}.attention.query_key_value.bias', qkv)
        _wb(f'{dst}.dense.base', f'{src}.attention.dense', m)
        _wb(f'{dst}.mlp_fc', f'{src}.mlp.dense_h_to_4h', m)
        _wb(f'{dst}.mlp_proj', f'{src}.mlp.dense_4h_to_h', m)
        _wb(f'{dst}.spa_local.conv', f'{src}.spa_local.conv1', m, bias=False)
        _wb(f'{dst}.temp_local.proj', f'{src}.temp_local.conv1', m,
            bias=False)
    m['pre_final_ln_scale'] = ('transformer.final_layernorm.weight', None)
    m['pre_final_ln_bias'] = ('transformer.final_layernorm.bias', None)
    m['final_ln_scale'] = ('mixins.final_layer.norm_final.weight', None)
    m['final_ln_bias'] = ('mixins.final_layer.norm_final.bias', None)
    _wb('final_linear', 'mixins.final_layer.linear', m)
    _wb('final_adaln', 'mixins.final_layer.adaLN_modulation.1', m)
    return m


def merge_sat_lora(state_dict: dict, alpha_over_r: float = 1.0) -> dict:
    """Fold SAT lora2 LoraMixin weights (matrix_A/matrix_B pairs attached to
    attention projections) into their base weights: W <- W + B @ A * scale.

    SAT lora2 key shape: '...attention.query_key_value.matrix_A.{part}' —
    naming varies across sat versions, so this matches any '*.matrix_A*'
    suffix and merges into the sibling '.weight'. Unmatched pairs raise."""
    sd = dict(state_dict)
    lora_as = [k for k in sd if '.matrix_A' in k]
    for ka in lora_as:
        kb = ka.replace('.matrix_A', '.matrix_B')
        base = re.sub(r'\.matrix_A.*$', '.weight', ka)
        if kb not in sd or base not in sd:
            raise KeyError(f'unpaired LoRA weight {ka}')
        a, b, w = sd[ka], sd[kb], sd[base]
        sd[base] = w + (b @ a) * alpha_over_r
        del sd[ka], sd[kb]
    return sd


def convert_dit(state_dict, module, strict: bool = True) -> dict:
    """A SAT DiT state dict (LoRA merged) -> the state dict of `module`, a
    port CogVideoDiT (its layer count and heads give the map)."""
    from .convert import convert_state_dict
    name_map = dit_name_map(len(module.layers), module.num_heads,
                            module.hidden_size // module.num_heads)
    return convert_state_dict(state_dict, name_map, module, strict)
