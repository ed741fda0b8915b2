from mymedialite_tpu_torch.utils.params import configure, echo, parse_options  # noqa: F401
