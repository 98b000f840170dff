"""Multi-checkpoint ensemble evaluation (counterpart of
``tools/ensemble_test.py``; reference: tools/ensemble_test.py):

    python -m s4former_tpu_torch.tools.ensemble_test CONFIG CKPT [CKPT ...]
        [--eval mIoU] [--device cuda|cpu]

Each test image (its pipeline image, as the JAX tool feeds it) goes
through every checkpoint's model by ``models/segmentors/inference.py``'s
``inference`` (whole or slide, per ``test_cfg``); the softmax
probabilities are averaged, then argmax. A prediction of another shape
than the label map is resized to it, nearest, before ``pre_eval`` /
``evaluate``. A checkpoint is a training checkpoint directory of the
port's runner (``work_dir/iter_N``) or a reference-layout ``.pth``. Runs on
a CUDA device unless ``--device cpu`` is given; without a card it fails.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Evaluate an ensemble')
    parser.add_argument('config')
    parser.add_argument('checkpoints', nargs='+')
    parser.add_argument('--eval', nargs='+', default=['mIoU'])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def ensemble_probs(segmentors, img, num_classes: int):
    """Mean of the segmentors' softmax probabilities [B, H, W, classes]
    (f32) of the NHWC batch ``img``."""
    from s4former_tpu_torch.models.segmentors.inference import inference
    return sum(inference(s.apply_fn, img, num_classes, mode=s.mode,
                         crop_size=s.crop_size, stride=s.stride)
               for s in segmentors) / len(segmentors)


def main(argv=None):
    """Evaluate; returns the metrics dict of ``dataset.evaluate``."""
    args = parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device(args.device)

    import numpy as np
    import torch
    from PIL import Image
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.data import build_dataset

    cfg = Config.fromfile(args.config)
    segs = [init_segmentor(cfg.copy(), c, device=device)
            for c in args.checkpoints]
    dataset = build_dataset(cfg.data['test'])
    n_cls = len(dataset.CLASSES)
    results = []
    for idx in range(len(dataset)):
        item = dataset.get_item_deterministic(idx, seed=0)
        if isinstance(item, list):
            item = item[0]
        img = torch.from_numpy(np.asarray(item['img'], np.float32)[None])
        with torch.inference_mode():
            pred = ensemble_probs(segs, img.to(device), n_cls).argmax(
                dim=-1).to(torch.int32)[0].cpu().numpy()
        gt = dataset.get_gt_seg_map(idx)
        if pred.shape != gt.shape:
            pred = np.asarray(Image.fromarray(pred.astype(np.uint8)).resize(
                (gt.shape[1], gt.shape[0]), Image.NEAREST))
        results.extend(dataset.pre_eval([pred], [idx]))
    metrics = dataset.evaluate(results, metric=args.eval)
    print(metrics)
    return metrics


if __name__ == '__main__':
    main()
