"""Per-frame video inference demo (counterpart of ``demo/video_demo.py``;
reference: demo/video_demo.py:10-106):

    python -m s4former_tpu_torch.demo.video_demo VIDEO CONFIG [CHECKPOINT]
        [--output-file out.avi] [--palette cityscapes] [--opacity 0.5]
        [--show] [--output-fourcc MJPG] [--output-fps N]
        [--output-height H] [--output-width W] [--device cuda|cpu]

Reads a video (a file or a webcam id) with OpenCV, segments every frame
(``apis.inference_segmentor``), paints the palette overlay and writes
and/or shows the result. ``cv2`` is imported when the demo runs, as in the
JAX demo: without OpenCV it raises ImportError. CHECKPOINT as for
``demo.image_demo``. Runs on a CUDA device unless ``--device cpu`` is
given; without a card it fails.
"""
import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Segment a video')
    parser.add_argument('video', help='video file or webcam id')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--palette', default='cityscapes',
                        help='palette name (any name core.class_names '
                             'knows: cityscapes, voc, ade20k, cocostuff, '
                             '...), used when the config has none; the '
                             'reference defaults to cityscapes too')
    parser.add_argument('--show', action='store_true')
    parser.add_argument('--show-wait-time', default=1, type=int)
    parser.add_argument('--output-file', default=None, type=str)
    parser.add_argument('--output-fourcc', default='MJPG', type=str)
    parser.add_argument('--output-fps', default=-1, type=int)
    parser.add_argument('--output-height', default=-1, type=int)
    parser.add_argument('--output-width', default=-1, type=int)
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Segment every frame; returns the number of frames."""
    args = parse_args(argv)
    if not (args.show or args.output_file):
        raise ValueError('At least one output should be enabled.')

    import cv2

    from s4former_tpu_torch.apis import inference_segmentor, init_segmentor
    from s4former_tpu_torch.core.class_names import get_palette
    from s4former_tpu_torch.parallel.distributed import resolve_device
    from s4former_tpu_torch.utils.palette import paint_result

    segmentor = init_segmentor(args.config, args.checkpoint,
                               device=resolve_device(args.device))
    palette = segmentor.cfg.get('palette') or get_palette(args.palette)

    src = int(args.video) if args.video.isdigit() else args.video
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise ValueError(f'cannot open video source {args.video!r}')
    in_fps = cap.get(cv2.CAP_PROP_FPS)
    in_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    in_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    writer = None
    if args.output_file is not None:
        fourcc = cv2.VideoWriter_fourcc(*args.output_fourcc)
        fps = args.output_fps if args.output_fps > 0 else in_fps
        w = args.output_width if args.output_width > 0 else in_w
        h = args.output_height if args.output_height > 0 else in_h
        writer = cv2.VideoWriter(args.output_file, fourcc, fps, (w, h))

    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            seg = inference_segmentor(segmentor, rgb)
            drawn = paint_result(rgb, seg, palette, args.opacity)
            drawn = cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR)
            if args.show:
                cv2.imshow('video_demo', drawn)
                cv2.waitKey(args.show_wait_time)
            if writer is not None:
                if drawn.shape[:2] != (h, w):
                    drawn = cv2.resize(drawn, (w, h))
                writer.write(drawn)
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    print(f'processed {n} frames'
          + (f'; saved {args.output_file}' if args.output_file else ''))
    return n


if __name__ == '__main__':
    main()
