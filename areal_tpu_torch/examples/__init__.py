"""Entry scripts of the port: ``python -m areal_tpu_torch.examples.<group>.<script> --config ...``,
the counterparts of the scripts under the repo's ``examples/`` (whose YAML files they read)."""
