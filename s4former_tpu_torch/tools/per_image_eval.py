"""Per-image eval breakdown of a checkpoint (counterpart of
``tools/per_image_eval.py``): pixel accuracy and per-image mIoU, to see
which images cap an aggregate score.

    python -m s4former_tpu_torch.tools.per_image_eval CONFIG CHECKPOINT
        [--cpu]

Each val image (its pipeline image, padded bottom/right to a multiple of
256 by ``core.runner._pad_to_bucket``) goes through the model's forward;
the logits of its valid region are resized bilinearly to the label's shape
(``ops.resize.resize_bilinear_np``) and argmaxed. Prints one JSON line an
image and one aggregate line, in the JAX tool's format. CHECKPOINT as for
``tools.test``. Runs on a CUDA device unless ``--cpu`` is given; without a
card it fails.
"""
import argparse
import json


def main(argv=None):
    """Evaluate; returns the printed records, the aggregate last."""
    ap = argparse.ArgumentParser(description='Per-image eval')
    ap.add_argument('config')
    ap.add_argument('checkpoint')
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device('cpu' if args.cpu else 'cuda')

    import numpy as np
    import torch
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import _pad_to_bucket
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.ops.resize import resize_bilinear_np

    cfg = Config.fromfile(args.config)
    model = init_segmentor(cfg, args.checkpoint, device=device).model
    ds = build_dataset(cfg.data['val'])
    align = model.align_corners
    records, accs = [], []
    for idx in range(len(ds)):
        item = ds.get_item_deterministic(idx, seed=0)
        if isinstance(item, list):
            item = item[0]
        img = np.asarray(item['img'], np.float32)[None]
        img, (vh, vw) = _pad_to_bucket(img, 256)
        with torch.inference_mode():
            logits = model(torch.from_numpy(img).to(device)).float()
        logits = logits.cpu().numpy()[0, :vh, :vw]
        gt = ds.get_gt_seg_map(idx)
        if logits.shape[:2] != gt.shape:
            logits = resize_bilinear_np(logits, gt.shape, align)
        pred = np.argmax(logits, -1).astype(np.int32)
        valid = gt != 255
        acc = float((pred[valid] == gt[valid]).mean())
        ious = []
        for c in np.unique(gt[valid]):
            inter = float(((pred == c) & (gt == c) & valid).sum())
            union = float((((pred == c) | (gt == c)) & valid).sum())
            ious.append(inter / max(union, 1.0))
        name = ds.img_infos[idx]['filename']
        accs.append((name, acc, float(np.mean(ious))))
        records.append({'image': name, 'acc': round(acc, 4),
                        'per_image_mIoU': round(float(np.mean(ious)), 4),
                        'classes': int(len(ious))})
        print(json.dumps(records[-1]))
    records.append({
        'n': len(accs),
        'mean_acc': round(float(np.mean([a for _, a, _ in accs])), 4),
        'mean_per_image_mIoU': round(
            float(np.mean([m for _, _, m in accs])), 4)})
    print(json.dumps(records[-1]))
    return records


if __name__ == '__main__':
    main()
