from rumpy_tpu_torch.config.loader import (  # noqa: F401
    NoneDict,
    load_config,
    to_none_dict,
    dump_toml,
    merge_overrides,
)
