"""Measure the bucketed eval's divergence from the exact one on a
checkpoint (counterpart of ``tools/measure_eval_divergence.py``):

    python -m s4former_tpu_torch.tools.measure_eval_divergence CONFIG
        CHECKPOINT [--bucket N] [--cpu]

Exact side, the reference's whole inference: the model's forward at the
pipeline image's own shape (the ViT corner-pads it to its patch size
itself, and resizes the logits back to the input), logits resized
bilinearly to the label's shape, argmax. Bucketed side: the image padded
to a multiple of ``--bucket`` (default the model's own pad divisor,
``core.runner.infer_pad_divisor``), the raw head logits
(``forward_decode_from_img``; their shape read from that forward) resized
by the composed per-image matrices of ``core.runner.eval_resize_matrices``
over the logit columns of the valid region, argmax. Prints one JSON line:
the mean argmax agreement and both mIoUs. At the default bucket the two
sides are the same computation; a larger bucket measures the pad band's
effect. This is a measurement: ``tools.test`` evaluates on the exact path
only. CHECKPOINT as for ``tools.test``. Runs on a CUDA device unless
``--cpu`` is given; without a card it fails.
"""
import argparse
import json


def support(v: int, logit_dim: int, img_dim: int, divisor: int) -> int:
    """The logit columns of a valid extent ``v`` in an input padded to
    ``img_dim``: all of them when the input is padded no further than the
    model's own pad (``divisor``), else the proportional share of the
    valid extent rounded up to ``divisor`` (JAX runner.py:442-460)."""
    pd = -(-v // divisor) * divisor
    if img_dim <= pd:
        return logit_dim
    return min(logit_dim, int(round(logit_dim * pd / img_dim)))


def main(argv=None):
    """Measure; returns the printed record."""
    ap = argparse.ArgumentParser(description='Bucketed vs exact eval')
    ap.add_argument('config')
    ap.add_argument('checkpoint')
    ap.add_argument('--bucket', type=int, default=None,
                    help='eval pre-pad bucket; default = the model pad '
                         'divisor (exact mode)')
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device('cpu' if args.cpu else 'cuda')

    import numpy as np
    import torch
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.metrics import pre_eval_to_metrics
    from s4former_tpu_torch.core.runner import (eval_resize_matrices,
                                                infer_pad_divisor)
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.ops.resize import resize_bilinear_np

    cfg = Config.fromfile(args.config)
    model = init_segmentor(cfg, args.checkpoint, device=device).model
    ds = build_dataset(cfg.data['val'])
    align = model.align_corners
    divisor = infer_pad_divisor(model)
    bucket = max(args.bucket if args.bucket else divisor, 1)

    agrees, pre_exact, pre_pad = [], [], []
    for idx in range(len(ds)):
        item = ds.get_item_deterministic(idx, seed=0)
        if isinstance(item, list):
            item = item[0]
        img = np.asarray(item['img'], np.float32)[None]
        h, w = img.shape[1:3]
        gt = ds.get_gt_seg_map(idx)
        gh, gw = gt.shape
        ph, pw = -(-h // bucket) * bucket, -(-w // bucket) * bucket
        padded = np.pad(img, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
        with torch.inference_mode():
            exact = model(torch.from_numpy(img).to(device)).float()
            logits = model.forward_decode_from_img(
                torch.from_numpy(padded).to(device), train=False).float()
            lh, lw = logits.shape[1:3]
            m_h, m_w = eval_resize_matrices(
                h, w, support(h, lh, ph, divisor),
                support(w, lw, pw, divisor), lh, lw, gt.shape, align,
                bucket)
            y = torch.einsum('oh,nhwc->nowc',
                             torch.from_numpy(m_h).to(device), logits)
            y = torch.einsum('pw,nhwc->nhpc',
                             torch.from_numpy(m_w).to(device), y)
            pad_pred = y.argmax(-1).to(torch.int32)[0, :gh, :gw]
        exact = exact.cpu().numpy()[0]
        if exact.shape[:2] != gt.shape:
            exact = resize_bilinear_np(exact, gt.shape, align)
        exact_pred = np.argmax(exact, -1).astype(np.int32)
        pad_pred = pad_pred.cpu().numpy()
        agrees.append(float((exact_pred == pad_pred).mean()))
        pre_exact.extend(ds.pre_eval([exact_pred], [idx]))
        pre_pad.extend(ds.pre_eval([pad_pred], [idx]))
    miou_exact = float(np.nanmean(
        pre_eval_to_metrics(pre_exact, ('mIoU',))['IoU']))
    miou_pad = float(np.nanmean(
        pre_eval_to_metrics(pre_pad, ('mIoU',))['IoU']))
    record = {'n_images': len(ds), 'bucket': bucket,
              'argmax_agreement_mean': round(float(np.mean(agrees)), 5),
              'mIoU_exact': round(miou_exact, 5),
              'mIoU_bucketed': round(miou_pad, 5),
              'abs_dmIoU': round(abs(miou_exact - miou_pad), 5)}
    print(json.dumps(record))
    return record


if __name__ == '__main__':
    main()
