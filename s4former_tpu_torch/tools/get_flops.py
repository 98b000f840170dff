"""Parameters and forward FLOPs (counterpart of ``tools/get_flops.py``;
reference: tools/get_flops.py:22-50, mmcv's get_model_complexity_info):

    python -m s4former_tpu_torch.tools.get_flops CONFIG [--shape H [W]]
        [--device cuda|cpu] [--cfg-options k=v ...]

Prints the parameters (M) and the GFLOPs of one forward at (1, H, W, 3),
counted by ``torch.utils.flop_counter.FlopCounterMode`` (2 FLOPs a
multiply-add of every matrix product and convolution; no elementwise
work). The ViT's attention is counted by formula, 4·B·H·L²·D (q kᵀ and
p v): the CUDA kernel is a ctypes call the counter cannot see, and what
the counter saw of its plain version on the CPU is taken back, so the
count is the same on either device. The JAX tool counts with XLA's cost
analysis, which also counts elementwise work, so its totals are larger.
Runs on a CUDA device unless ``--device cpu`` is given; without a card it
fails.
"""
import argparse

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Get FLOPs of a segmentor')
    parser.add_argument('config')
    parser.add_argument('--shape', type=int, nargs='+', default=[512, 512])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def count_flops(model, img):
    """(FLOPs of ``model(img)``, the attention's share of them). Every ViT
    layer calls its attention through the name ``vit.multi_head_attention``,
    which is wrapped while counting: each call adds 4·B·H·Lq·Lk·D and takes
    back what the counter saw inside it (the plain version's products on
    the CPU, nothing of the kernel's ctypes call on the card). A model with
    a ViT whose attention the wrapper never saw raises, so a ViT that comes
    to call its attention another way cannot go uncounted."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    import s4former_tpu_torch.models.backbones.vit as vit
    counter = FlopCounterMode(display=False)
    attention, seen = [0], [0]
    attend = vit.multi_head_attention

    def counted(q, k, v, bias=None, **kwargs):
        b, lq, h, d = q.shape
        attention[0] += 4 * b * h * lq * k.shape[1] * d
        start = counter.get_total_flops()
        out = attend(q, k, v, bias=bias, **kwargs)
        seen[0] += counter.get_total_flops() - start
        return out

    vit.multi_head_attention = counted
    try:
        with counter, torch.inference_mode():
            model(img)
    finally:
        vit.multi_head_attention = attend
    if attention[0] == 0 and any(isinstance(m, vit.VisionTransformer)
                                 for m in model.modules()):
        raise RuntimeError('get_flops: the ViT ran no attention through '
                           'vit.multi_head_attention; its attention would '
                           'go uncounted')
    return (counter.get_total_flops() - seen[0] + attention[0],
            attention[0])


def main(argv=None):
    """Count; returns {'params', 'flops', 'attention_flops', 'shape'}."""
    args = parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device(args.device)

    import torch
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    h, w = (args.shape * 2)[:2]
    model = init_segmentor(cfg, device=device).model
    n_params = sum(p.numel() for p in model.parameters())
    flops, attention = count_flops(
        model, torch.zeros((1, h, w, 3), device=device))
    print('=' * 60)
    print(f'Input shape: (1, {h}, {w}, 3)')
    print(f'Params: {n_params / 1e6:.2f} M')
    print(f'FLOPs (FlopCounterMode + attention by formula, fwd): '
          f'{flops / 1e9:.2f} GFLOPs')
    print('=' * 60)
    return {'params': n_params, 'flops': flops,
            'attention_flops': attention, 'shape': (1, h, w, 3)}


if __name__ == '__main__':
    main()
