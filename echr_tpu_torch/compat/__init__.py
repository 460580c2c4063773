from echr_tpu_torch.compat.torch_import import (  # noqa: F401
    import_cg_state_dict,
    import_reference_checkpoint,
    import_tap_state_dict,
)
