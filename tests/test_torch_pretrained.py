"""Backbone-only pretrained files through the port, against the JAX
package on the CPU, in f32.

A DeiT file as the flagship configs name it (``init_cfg.checkpoint``) holds
the backbone alone, with bare OpenMMLab keys or timm names, DeiT's
classifier ``head.*``, ``dist_token`` and final ``norm.*``, and a
pos-embed on another grid. Such files are written here from the JAX
package's ``export_reference_state_dict`` of perturbed tiny weights. Both
packages load every backbone tensor from them, to the same values (the
pos-embed resized to the crop's grid); with the same heads they serve the
same probabilities. A file that overlays nothing raises, in
``init_segmentor`` and in ``tools.train``.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu import apis as japis
from s4former_tpu.config import Config as JConfig
from s4former_tpu.core.checkpoint import export_reference_state_dict
from s4former_tpu.models.segmentors.inference import inference as j_inference
from s4former_tpu_torch import apis
from s4former_tpu_torch.core.checkpoint import (load_reference_state_dict,
                                                normalize_backbone_keys,
                                                state_dict_from_jax_variables)
from s4former_tpu_torch.tools import train as train_cli
from s4former_tpu_torch.utils.logger import get_root_logger
from tests._torch_port import (image_batch, jax_variables, write_cli_config,
                               write_tiny_config)

# probabilities in f32 on both sides (sums in another order)
ATOL = 1e-4
# the same float32 numbers, moved (the pos-embed through the same bicubic
# torch interpolate on both sides)
WEIGHT_ATOL = 1e-6
TIMM = (('ln1.', 'norm1.'), ('ln2.', 'norm2.'),
        ('attn.attn.in_proj_weight', 'attn.qkv.weight'),
        ('attn.attn.in_proj_bias', 'attn.qkv.bias'),
        ('attn.attn.out_proj.', 'attn.proj.'),
        ('ffn.layers.0.0.', 'mlp.fc1.'), ('ffn.layers.1.', 'mlp.fc2.'))


def to_timm(key: str) -> str:
    """An OpenMMLab ViT key (no ``backbone.``) -> its timm DeiT name."""
    if key.startswith('layers.'):
        i, rest = key[len('layers.'):].split('.', 1)
        for mm, timm in TIMM:
            rest = rest.replace(mm, timm)
        return f'blocks.{i}.{rest}'
    return key.replace('patch_embed.projection.', 'patch_embed.proj.')


def deit_file(variables, path, layout: str, grid: int = 6):
    """A backbone-only file of ``variables``' ViT with bare keys, in the
    OpenMMLab or the timm layout, plus what a DeiT file carries besides:
    a pos-embed on a ``grid`` x ``grid`` grid, ``dist_token``, the final
    ``norm.*`` and the classifier ``head.*``."""
    sd = export_reference_state_dict(variables)
    rs = np.random.RandomState(11)
    bare = {k[len('backbone.'):]: np.asarray(v) for k, v in sd.items()
            if k.startswith('backbone.')}
    dim = bare['cls_token'].shape[-1]
    bare['pos_embed'] = rs.normal(size=(1, 1 + grid * grid, dim)).astype(
        np.float32)
    if layout == 'timm':
        bare = {to_timm(k): v for k, v in bare.items()}
    extras = {'dist_token': (1, 1, dim), 'norm.weight': (dim,),
              'norm.bias': (dim,), 'head.weight': (1000, dim),
              'head.bias': (1000,)}
    for k, shape in extras.items():
        bare[k] = rs.normal(size=shape).astype(np.float32)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in bare.items()},
               path)
    return str(path)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp('pretrained')
    cfg = write_tiny_config(d)
    js = japis.init_segmentor(cfg)
    variables = jax_variables(js, seed=4)
    files = {layout: deit_file(variables, d / f'deit_{layout}.pth', layout)
             for layout in ('bare', 'timm')}
    return dict(cfg=cfg, files=files, dir=d)


def test_timm_names_map_to_the_ports_modules():
    keys = ['blocks.3.norm1.weight', 'blocks.3.attn.qkv.bias',
            'blocks.3.attn.proj.weight', 'blocks.3.mlp.fc2.bias',
            'patch_embed.proj.weight', 'norm.bias', 'layers.0.ln2.weight',
            'layers.0.attn.attn.out_proj.bias']
    assert list(normalize_backbone_keys({k: k for k in keys})) == [
        'layers.3.ln1.weight', 'layers.3.attn.attn.in_proj_bias',
        'layers.3.attn.attn.out_proj.weight', 'layers.3.ffn.layers.1.bias',
        'patch_embed.projection.weight', 'ln1.bias', 'layers.0.ln2.weight',
        'layers.0.attn.attn.out_proj.bias']


@pytest.mark.parametrize('layout', ['bare', 'timm'])
def test_backbone_file_loads_every_backbone_tensor(setup, layout):
    """Both packages overlay the same backbone from the file, and with the
    same heads serve the same probabilities."""
    path = setup['files'][layout]
    jseg = japis.init_segmentor(setup['cfg'], checkpoint=path)
    logger = get_root_logger()
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    try:
        seg = apis.init_segmentor(setup['cfg'], checkpoint=path,
                                  device='cpu')
    finally:
        logger.removeHandler(handler)
    want = state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jseg.variables))
    got = seg.model.state_dict()
    backbone = sorted(k for k in got if k.startswith('backbone.'))
    assert any(f'({len(backbone)} of {len(backbone)} backbone tensors)'
               in r for r in records), records
    loaded = load_reference_state_dict(path, dst_grid=(4, 4))
    assert set(backbone) <= set(loaded)
    for k in backbone:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=WEIGHT_ATOL, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), loaded[k].numpy())
    # the heads are seeded differently in the two packages: give the port
    # the JAX package's
    seg.model.load_state_dict({k: v for k, v in want.items()
                               if not k.startswith('backbone.')},
                              strict=False)
    x = image_batch(3, 64, 80)
    j = japis.Segmentor(jseg.model, jseg.variables,
                        JConfig.fromfile(setup['cfg']))
    ref = np.asarray(j_inference(j.apply_fn, jnp.asarray(x), 5,
                                 mode='whole', crop_size=j.crop_size))
    out = seg.probs(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_file_that_overlays_nothing_raises(setup):
    path = setup['dir'] / 'unrelated.pth'
    torch.save({'encoder.weight': torch.zeros(3),
                'fc.bias': torch.zeros(2)}, path)
    with pytest.raises(ValueError, match='overlays none'):
        apis.init_segmentor(setup['cfg'], checkpoint=str(path),
                            device='cpu')


@pytest.mark.parametrize('layout', ['bare', 'timm', 'unrelated'])
def test_train_cli_reports_what_the_file_overlaid(setup, tmp_path, layout):
    """``tools.train --load-from`` logs every backbone tensor loaded from
    a DeiT file, and refuses a file that overlays nothing before it
    trains."""
    cfg = write_cli_config(tmp_path, str(tmp_path / 'unused_split.txt'))
    # the CLI config's ViT is the tiny config's: the same backbone keys
    if layout == 'unrelated':
        path = tmp_path / 'unrelated.pth'
        torch.save({'encoder.weight': torch.zeros(3)}, path)
        with pytest.raises(ValueError, match='overlays none'):
            train_cli.main([cfg, '--work-dir', str(tmp_path / 'w'),
                            '--device', 'cpu', '--load-from', str(path)])
        assert not (tmp_path / 'w' / 'metrics.jsonl').exists()
        return
    wd = tmp_path / 'w'
    train_cli.main([cfg, '--work-dir', str(wd), '--device', 'cpu',
                    '--no-validate', '--max-iters', '1', '--load-from',
                    setup['files'][layout]])
    log = ''.join(p.read_text() for p in wd.glob('*.log'))
    n = sum(1 for line in log.splitlines() if 'overlaid' in line and
            '(28 of 28 backbone tensors)' in line)
    assert n == 1, log
