"""High-level serving API (counterpart of ``s4former_tpu/apis.py``;
reference: mmseg/apis/inference.py).

- ``init_segmentor(config, checkpoint=None, seed=0, device='cuda')``: config
  (+ reference-layout ``.pth``) -> a ``Segmentor`` on ``device``. Seeded
  weights come from a ``torch.Generator`` on the CPU, so a seed gives the
  same model on every device.
- ``inference_segmentor``: image path or HWC array -> [H, W] label map.
- ``inference_with_teacher_pasa``: the EMA teacher's confidence builds the
  PASA bias for the student's forward.
- ``inference_segmentor_with_attn``: also returns logits and attention maps.
- ``inference_segmentor_tta``: multi-scale + flip test-time augmentation,
  softmax averaged at the original size (``tta_probs``).
- ``single_device_test``: a dataset's pipeline images through ``predict``,
  as per-image confusion histograms (or label maps).
- ``show_result_pyplot``: a label map painted over its image with a
  palette (the VOC one by default), saved or returned.

Images are NHWC, normalised and padded to the crop as in the JAX package.
The runs are eval mode under ``torch.inference_mode``.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

_DEFAULT_NORM = dict(mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375])
# the reference --aug-test's MultiScaleFlipAug ratios
TTA_RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


class Segmentor:
    """A built model on its device + config, ready for inference."""

    def __init__(self, model, cfg, device):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_classes = model.num_classes
        test_cfg = (cfg.get('model', {}).get('test_cfg') or {}) \
            if cfg is not None else {}
        self.mode = test_cfg.get('mode', 'whole')
        default_crop = tuple(cfg.get('crop_size', (512, 512))) \
            if cfg is not None else (512, 512)
        self.crop_size = tuple(test_cfg.get('crop_size', default_crop))
        self.stride = tuple(test_cfg.get('stride', (341, 341)))

    def apply_fn(self, img: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(img)

    def probs(self, img: torch.Tensor, flip: bool = False) -> torch.Tensor:
        """Softmax probabilities [B, H, W, classes] in the config's test
        mode (whole or slide)."""
        from s4former_tpu_torch.models.segmentors.inference import inference
        with torch.inference_mode():
            return inference(self.apply_fn, img, self.num_classes,
                             mode=self.mode, crop_size=self.crop_size,
                             stride=self.stride, flip=flip)

    def predict(self, img: torch.Tensor) -> torch.Tensor:
        """argmax label map [B, H, W] int32."""
        from s4former_tpu_torch.models.segmentors.inference import predict
        with torch.inference_mode():
            return predict(self.apply_fn, img, self.num_classes,
                           mode=self.mode, crop_size=self.crop_size,
                           stride=self.stride)


def init_segmentor(config, checkpoint: Optional[str] = None,
                   seed: int = 0, device='cuda') -> Segmentor:
    """(reference inference.py:12). ``config``: a path or a ``Config``;
    ``checkpoint``: an mmseg-layout ``.pth`` or a backbone-only DeiT file
    (bare or timm keys), whose entries overlay the seeded weights (a
    backbone-only file keeps the seeded heads), or a training checkpoint
    directory of the port's runner (``work_dir/iter_N``), whose student
    is loaded whole. The package logger ('s4former_tpu_torch') says how
    many of the model's tensors a file overlaid, where a CLI has set it up
    (``utils.logger.get_root_logger``); this function adds no handler, so
    it writes nothing to stdout, as JAX's writes nothing. A file that
    overlays none raises ValueError."""
    import os.path as osp

    import s4former_tpu_torch.models  # noqa: F401  (registers modules)
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.checkpoint import (load_model_state_dict,
                                                    load_reference_state_dict,
                                                    overlay_state_dict)
    from s4former_tpu_torch.models import (build_segmentor,
                                           init_segmentor_weights)
    from s4former_tpu_torch.models.init_utils import skip_default_init

    logger = logging.getLogger('s4former_tpu_torch')
    if isinstance(config, str):
        config = Config.fromfile(config)
    with skip_default_init():
        model = build_segmentor(config.model)
    init_segmentor_weights(model, torch.Generator().manual_seed(seed))
    if checkpoint and osp.isdir(checkpoint):
        model.load_state_dict(load_model_state_dict(checkpoint))
        logger.info(f'loaded {checkpoint}')
    elif checkpoint:
        bb = config.model.get('backbone', {})
        crop = tuple(config.get('crop_size', (512, 512)))
        patch = bb.get('patch_size', 16)
        sd = load_reference_state_dict(
            checkpoint, dst_grid=(crop[0] // patch, crop[1] // patch))
        n = overlay_state_dict(model, sd, checkpoint)
        logger.info(
            f'{checkpoint} overlaid {n["loaded"]} of the model\'s '
            f'{n["total"]} tensors ({n["backbone_loaded"]} of '
            f'{n["backbone_total"]} backbone tensors)')
    model.to(device).eval()
    return Segmentor(model, config, device)


def _prepare_image(segmentor: Segmentor, img) -> Tuple[np.ndarray,
                                                       Tuple[int, int]]:
    """Path or HWC array -> normalised [1, H', W', 3] f32 padded (bottom/
    right, zeros) to at least the crop, and the original (h, w)."""
    if isinstance(img, str):
        from PIL import Image
        with Image.open(img) as im:
            img = np.asarray(im.convert('RGB'))
    img = np.asarray(img).astype(np.float32)
    norm = segmentor.cfg.get('img_norm_cfg', _DEFAULT_NORM) \
        if segmentor.cfg is not None else _DEFAULT_NORM
    x = (img - np.asarray(norm['mean'], np.float32)) / \
        np.asarray(norm['std'], np.float32)
    h, w = x.shape[:2]
    ch, cw = segmentor.crop_size
    ph, pw = max(ch, h), max(cw, w)
    x = np.pad(x, ((0, ph - h), (0, pw - w), (0, 0)))
    return x[None], (h, w)


def inference_segmentor(segmentor: Segmentor, img) -> np.ndarray:
    """(reference inference.py:70): path or HWC array -> [H, W] int32."""
    x, (h, w) = _prepare_image(segmentor, img)
    seg = segmentor.predict(torch.from_numpy(x).to(segmentor.device))[0]
    return seg.cpu().numpy()[:h, :w]


def inference_segmentor_with_attn(segmentor: Segmentor, img):
    """(reference inference.py:102): (seg_map, logits, attention maps at
    the backbone's out_indices)."""
    from s4former_tpu_torch.ops.resize import resize_bilinear
    x, (h, w) = _prepare_image(segmentor, img)
    x = torch.from_numpy(x).to(segmentor.device)
    model = segmentor.model
    with torch.inference_mode():
        feats, (attns, _) = model.extract_feat(x, return_attn=True)
        logits = model.decode_logits(feats)
        if tuple(logits.shape[1:3]) != tuple(x.shape[1:3]):
            logits = resize_bilinear(logits, tuple(x.shape[1:3]), False)
    seg = logits.argmax(dim=-1)[0].to(torch.int32).cpu().numpy()[:h, :w]
    return seg, logits.float().cpu().numpy()[:, :h, :w], \
        [a.cpu().numpy() for a in attns]


def inference_with_teacher_pasa(segmentor: Segmentor, img,
                                ema_state_dict: Dict[str, torch.Tensor],
                                attn_mask_weight: float = 5.0,
                                patch_size: int = 16) -> np.ndarray:
    """Test-time PASA (reference encode_decode, encoder_decoder.py:265-296):
    the EMA teacher (the same model run with ``ema_state_dict``, in the
    student's key names: backbone, neck if any, decode head) gives a
    continuous max-softmax confidence, which builds the additive attention
    bias for the student's forward. The ViT only, as in the JAX package: a
    MiT takes its PASA input as a raw map and is refused, and a ViT
    without a cls token raises ValueError (``semi.pasa.require_cls_token``;
    JAX fails on it too)."""
    from s4former_tpu_torch.models.backbones.mit import MixVisionTransformer
    from s4former_tpu_torch.ops.resize import resize_bilinear
    from s4former_tpu_torch.semi.pasa import (build_pasa_bias,
                                              require_cls_token)
    if isinstance(segmentor.model.backbone, MixVisionTransformer):
        raise NotImplementedError('teacher-PASA inference is not ported for '
                                  'the MiT (ViT token bias only)')
    require_cls_token(segmentor.model.backbone, 'teacher-PASA inference')
    x, (h, w) = _prepare_image(segmentor, img)
    x = torch.from_numpy(x).to(segmentor.device)
    model = segmentor.model
    teacher = {k: v.to(segmentor.device) for k, v in ema_state_dict.items()
               if k.startswith(('backbone.', 'neck.', 'decode_head.'))}
    with torch.inference_mode():
        # the teacher's forward_decode_from_img, module by module
        feats = functional_call(
            model.backbone, _strip(teacher, 'backbone.'), (x,), strict=True)
        if model.neck is not None:
            feats = functional_call(model.neck, _strip(teacher, 'neck.'),
                                    (feats,), strict=True)
        if isinstance(model.decode_head, torch.nn.ModuleList):
            # a cascade: each stage on the features and the last's logits
            t_logits = None
            for i, head in enumerate(model.decode_head):
                t_logits = functional_call(
                    head, _strip(teacher, f'decode_head.{i}.'),
                    (feats if i == 0 else list(feats) + [t_logits],),
                    strict=True)
        else:
            t_logits = functional_call(
                model.decode_head, _strip(teacher, 'decode_head.'),
                (feats,), strict=True)
        max_prob = torch.softmax(t_logits.float(), dim=-1).amax(dim=-1)
        bsz, hh, ww = max_prob.shape
        # pool the confidence map to the backbone token grid
        grid_h = x.shape[1] // patch_size
        pool = max(hh // grid_h, 1)
        unconf = (1.0 - max_prob).reshape(bsz, hh // pool, pool,
                                          ww // pool, pool)
        unconf = unconf.mean(dim=(2, 4)).reshape(bsz, -1)
        bias = build_pasa_bias(unconf, attn_mask_weight, adaptive=True)
        logits = model.forward_decode_from_img(x, attn_bias=bias)
        if tuple(logits.shape[1:3]) != tuple(x.shape[1:3]):
            logits = resize_bilinear(logits, tuple(x.shape[1:3]), False)
    return logits.argmax(dim=-1)[0].to(torch.int32).cpu().numpy()[:h, :w]


def _strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def tta_probs(segmentor: Segmentor, img, ratios=TTA_RATIOS,
              flip: bool = True) -> torch.Tensor:
    """Softmax probabilities [H, W, classes] (f32, on the segmentor's
    device) of an image path or HWC uint8 array, averaged over the image
    resized (PIL bilinear) by each of ``ratios``, each also flipped when
    ``flip``, and brought back to the original size (JAX apis.py:167-192;
    reference aug_test, encoder_decoder.py:1253-1271)."""
    from s4former_tpu_torch.data.pipelines.transforms import (_pil_resize,
                                                              _read_rgb)
    from s4former_tpu_torch.ops.resize import resize_bilinear
    img = _read_rgb(img) if isinstance(img, str) else np.asarray(img)
    h, w = img.shape[:2]
    total = None
    for r in ratios:
        scaled = _pil_resize(img.astype(np.uint8),
                             (max(1, int(w * r)), max(1, int(h * r))))
        x, (sh, sw) = _prepare_image(segmentor, scaled)
        probs = segmentor.probs(torch.from_numpy(x).to(segmentor.device),
                                flip=flip)[:, :sh, :sw]
        probs = resize_bilinear(probs, (h, w), False)[0]
        total = probs if total is None else total + probs
    return total / len(ratios)


def inference_segmentor_tta(segmentor: Segmentor, img, ratios=TTA_RATIOS,
                            flip: bool = True) -> np.ndarray:
    """Multi-scale + flip TTA label map [H, W] int32 (JAX apis.py:167):
    the argmax of ``tta_probs``."""
    return tta_probs(segmentor, img, ratios, flip).argmax(-1).to(
        torch.int32).cpu().numpy()


def single_device_test(segmentor: Segmentor, dataset,
                       pre_eval: bool = True, progress_every: int = 50,
                       logger=None):
    """(reference test.py:34 single_gpu_test, pre_eval mode): each item's
    pipeline image through ``segmentor.predict``; a label map of another
    shape than the ground truth is resized to it, nearest."""
    from PIL import Image
    results = []
    for idx in range(len(dataset)):
        item = dataset.get_item_deterministic(idx, seed=0)
        if isinstance(item, list):
            item = item[0]
        img = torch.from_numpy(np.asarray(item['img'], np.float32)[None])
        pred = segmentor.predict(img.to(segmentor.device))[0].cpu().numpy()
        gt = dataset.get_gt_seg_map(idx)
        if pred.shape != gt.shape:
            pred = np.asarray(Image.fromarray(pred.astype(np.uint8)).resize(
                (gt.shape[1], gt.shape[0]), Image.NEAREST))
        results.extend(dataset.pre_eval([pred], [idx]) if pre_eval
                       else [pred])
        if logger and (idx + 1) % progress_every == 0:
            logger.info(f'{idx + 1}/{len(dataset)}')
    return results


def show_result_pyplot(segmentor: Segmentor, img, seg: np.ndarray,
                       palette=None, opacity: float = 0.5,
                       out_file: Optional[str] = None) -> np.ndarray:
    """(reference inference.py:134; JAX apis.py:218): ``seg`` painted over
    ``img`` (a path or an HWC array) with ``palette``, the VOC palette by
    default; saved to ``out_file`` when given. Returns the RGB uint8
    overlay."""
    from PIL import Image
    from s4former_tpu_torch.data.datasets.custom import PascalVOCDataset
    from s4former_tpu_torch.utils.palette import paint_result
    out = paint_result(img, seg, palette or PascalVOCDataset.PALETTE,
                       opacity)
    if out_file:
        Image.fromarray(out).save(out_file)
    return out
