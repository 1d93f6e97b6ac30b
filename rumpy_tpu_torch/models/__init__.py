from rumpy_tpu_torch.registry import available_models, get_model, register_model  # noqa: F401
