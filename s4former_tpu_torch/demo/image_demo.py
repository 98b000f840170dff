"""Single-image inference demo (counterpart of ``demo/image_demo.py``;
reference: demo/image_demo.py:28-37):

    python -m s4former_tpu_torch.demo.image_demo IMG CONFIG [CHECKPOINT]
        [--out demo_result.png] [--opacity 0.5] [--device cuda|cpu]

CHECKPOINT is a reference-layout ``.pth`` or a training checkpoint
directory of the port's runner (``work_dir/iter_N``). The prediction is
painted over the image with the config's ``palette`` (the VOC palette when
it has none) by ``apis.show_result_pyplot`` and saved to ``--out``. Runs on
a CUDA device unless ``--device cpu`` is given; without a card it fails.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Segment one image')
    parser.add_argument('img')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--out', default='demo_result.png')
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Segment and paint; returns the label map."""
    args = parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device(args.device)

    import numpy as np
    from s4former_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                         show_result_pyplot)

    segmentor = init_segmentor(args.config, args.checkpoint, device=device)
    pred = inference_segmentor(segmentor, args.img)
    show_result_pyplot(segmentor, args.img, pred,
                       palette=segmentor.cfg.get('palette'),
                       opacity=args.opacity, out_file=args.out)
    print(f'saved {args.out}; classes present: {np.unique(pred).tolist()}')
    return pred


if __name__ == '__main__':
    main()
