"""Print the merged config (counterpart of ``tools/print_config.py``;
reference: tools/print_config.py):

    python -m s4former_tpu_torch.tools.print_config CONFIG
        [--cfg-options k=v ...]

Prints ``Config:`` and the config's ``pretty_text()``. Touches no device.
"""
import argparse

from s4former_tpu_torch.config import DictAction


def main(argv=None):
    """Print; returns the text printed."""
    parser = argparse.ArgumentParser(description='Print a config')
    parser.add_argument('config')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    args = parser.parse_args(argv)
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    text = f'Config:\n{cfg.pretty_text()}'
    print(text)
    return text


if __name__ == '__main__':
    main()
