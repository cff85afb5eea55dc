"""RLlib on the port's runtime. Port of ray_tpu/rllib: the environments,
the model catalog, the connectors and the vectorized EnvRunner; the
on-policy algorithms on CPU rollout actors with their learners on the
card, in the driver or as a LearnerGroup (PPO, IMPALA, APPO, PG, A2C,
A3C); ES and ARS, numpy on CPU actors; the offline algorithms BC and
MARWIL; the contextual bandits and the random baseline. The exports keep
the reference's `__all__` order for the names ported so far; the
off-policy and other one-process algorithms are ROADMAP A13's rest."""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bandit import (Bandit, BanditConfig,
                                        LinearDiscreteBandit)
from ray_tpu_torch.rllib.catalog import (MODEL_REGISTRY, ModelSpec, get_model,
                                         register_model)
from ray_tpu_torch.rllib.connectors import (ClipActions, Connector,
                                            ConnectorPipeline, FlattenObs,
                                            FrameStack, NormalizeObs,
                                            RescaleActions)
from ray_tpu_torch.rllib.env import (ENV_REGISTRY, CartPole, DualCartPole,
                                     Env, MultiAgentEnv, Pendulum,
                                     VisualCatch, make_env)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.es import ARS, ES, ARSConfig, ESConfig
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.offline import (BC, MARWIL, BCConfig, JsonReader,
                                         MARWILConfig, write_offline_json)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.ppo import (PPO, PPOConfig, PPOLearner,
                                     make_ppo_loss)
from ray_tpu_torch.rllib.random_agent import RandomAgent, RandomAgentConfig

__all__ = ["PPO", "PPOConfig",
           "Impala", "ImpalaConfig", "APPO", "APPOConfig", "A2C", "A2CConfig",
           "PG", "PGConfig",
           "BC", "BCConfig", "MARWIL", "MARWILConfig", "JsonReader",
           "write_offline_json",
           "ModelSpec", "MODEL_REGISTRY", "get_model", "register_model",
           "Env", "CartPole", "Pendulum", "ENV_REGISTRY", "make_env",
           "Connector", "ConnectorPipeline", "FlattenObs", "NormalizeObs",
           "FrameStack", "ClipActions", "RescaleActions", "EnvRunner",
           "A3C", "A3CConfig", "ES", "ESConfig", "ARS", "ARSConfig",
           "Bandit", "BanditConfig", "LinearDiscreteBandit",
           "RandomAgent", "RandomAgentConfig",
           # The port's own names: the pixel and multi-agent envs (in the
           # reference's env.py, not its exports) and PPO's learner.
           "VisualCatch", "MultiAgentEnv", "DualCartPole", "PPOLearner",
           "make_ppo_loss"]
