"""Reinforcement learning on the card: the trading env, the DQN, the PBT
fleet with its winner's adoption, and the continuous trainer service (the
JAX package's `rl` exports)."""

from ai_crypto_trader_tpu_torch.rl.env import (  # noqa: F401
    EnvParams,
    EnvState,
    assert_transfer_compatible,
    env_reset,
    env_step,
    make_env_params,
    obs_size,
)
from ai_crypto_trader_tpu_torch.rl.dqn import (  # noqa: F401
    DQNConfig,
    DQNState,
    Hypers,
    act,
    dqn_init,
    evaluate_policy,
    hypers_from_config,
    poisoned_members,
    train_dqn,
    train_iteration,
    train_iterations,
)
from ai_crypto_trader_tpu_torch.rl.population import (  # noqa: F401
    PBTConfig,
    PBTResult,
    PopState,
    adopt_winner,
    best_params,
    pbt_env_params,
    pop_init,
    train_pbt,
)
from ai_crypto_trader_tpu_torch.rl.trainer_service import (  # noqa: F401
    PBT_CHECKPOINT_KIND,
    PBTTrainerService,
    checkpoint_payload,
    load_checkpoint,
    restore_checkpoint,
)
