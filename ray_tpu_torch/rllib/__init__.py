"""RLlib's learners. Port of the part of ray_tpu/rllib that needs no
runtime: the environments, the model catalog, PPO's loss and learner,
and the offline algorithms BC and MARWIL, which train in one process."""

from ray_tpu_torch.rllib.catalog import (MODEL_REGISTRY, ModelSpec, get_model,
                                         register_model)
from ray_tpu_torch.rllib.env import (ENV_REGISTRY, CartPole, DualCartPole,
                                     Env, MultiAgentEnv, Pendulum,
                                     VisualCatch, make_env)
from ray_tpu_torch.rllib.offline import (BC, MARWIL, BCConfig, JsonReader,
                                         MARWILConfig, write_offline_json)
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner, make_ppo_loss

__all__ = ["ModelSpec", "MODEL_REGISTRY", "get_model", "register_model",
           "Env", "CartPole", "Pendulum", "VisualCatch", "MultiAgentEnv",
           "DualCartPole", "ENV_REGISTRY", "make_env",
           "BC", "BCConfig", "MARWIL", "MARWILConfig", "JsonReader",
           "write_offline_json", "PPOConfig", "PPOLearner", "make_ppo_loss"]
