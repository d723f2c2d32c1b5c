from vlite_fast_tpu_torch.analysis import baseband, localization  # noqa: F401
