"""Command-line entry points, ``python -m s4former_tpu_torch.tools.<name>``:
``train``, ``test``, ``profile_trace``, ``print_config``, ``publish_model``,
``ensemble_test``, ``benchmark``, ``get_flops``, ``per_image_eval`` and
``measure_eval_divergence``; the launch scripts ``dist_train.sh``,
``dist_test.sh``, ``slurm_train.sh`` and ``slurm_test.sh``."""
