from s2p_tpu_torch.world_model.ensemble import (
    EnsembleLinear,
    EnsembleTransition,
    ensemble_nll_loss,
    jax_ensemble_params_from_state_dict,
    make_ensemble_train_step,
    restore_members,
    save_members,
    soft_clamp,
    split_saved,
    state_dict_from_jax_ensemble_params,
)
from s2p_tpu_torch.world_model.rollout import (
    compute_normalization,
    generate_augmented_dataset,
    generate_multistep_dataset,
)

__all__ = [
    "EnsembleLinear",
    "EnsembleTransition",
    "ensemble_nll_loss",
    "jax_ensemble_params_from_state_dict",
    "make_ensemble_train_step",
    "restore_members",
    "save_members",
    "soft_clamp",
    "split_saved",
    "state_dict_from_jax_ensemble_params",
    "compute_normalization",
    "generate_augmented_dataset",
    "generate_multistep_dataset",
]
