"""RLlib on the port's runtime. Port of ray_tpu/rllib: the environments,
the model catalog, the connectors and the vectorized EnvRunner; the
on-policy algorithms on CPU rollout actors with their learners on the
card, in the driver or as a LearnerGroup (PPO, IMPALA, APPO, PG, A2C,
A3C); ES and ARS, numpy on CPU actors; the offline algorithms BC and
MARWIL; the off-policy family (DQN, SimpleQ, Ape-X, Rainbow, R2D2,
TD3/DDPG, SAC, MADDPG, SlateQ, AlphaZero) on CPU rollout and self-play
actors with their learners on the card in the driver; the offline CQL,
CRR and DT; the one-process QMIX (with CoopSwitch) and DreamerV3, whose
acting runs on the card; the contextual bandits and the random
baseline. The exports keep the reference's `__all__` order."""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.alphazero import (MCTS, AlphaZero, AlphaZeroConfig,
                                           TicTacToe)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bandit import (Bandit, BanditConfig,
                                        LinearDiscreteBandit)
from ray_tpu_torch.rllib.catalog import (MODEL_REGISTRY, ModelSpec, get_model,
                                         register_model)
from ray_tpu_torch.rllib.connectors import (ClipActions, Connector,
                                            ConnectorPipeline, FlattenObs,
                                            FrameStack, NormalizeObs,
                                            RescaleActions)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.crr import CRR, CRRConfig
from ray_tpu_torch.rllib.ddpg import DDPG, TD3, DDPGConfig, TD3Config
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.dt import DT, DTConfig
from ray_tpu_torch.rllib.env import (ENV_REGISTRY, CartPole, DualCartPole,
                                     Env, MultiAgentEnv, Pendulum,
                                     VisualCatch, make_env)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.es import ARS, ES, ARSConfig, ESConfig
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig
from ray_tpu_torch.rllib.maddpg import MADDPG, CoopNav, MADDPGConfig
from ray_tpu_torch.rllib.offline import (BC, MARWIL, BCConfig, JsonReader,
                                         MARWILConfig, write_offline_json)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.ppo import (PPO, PPOConfig, PPOLearner,
                                     make_ppo_loss)
from ray_tpu_torch.rllib.qmix import QMIX, CoopSwitch, QMIXConfig
from ray_tpu_torch.rllib.r2d2 import R2D2, R2D2Config, SequenceReplay
from ray_tpu_torch.rllib.rainbow import Rainbow, RainbowConfig
from ray_tpu_torch.rllib.random_agent import RandomAgent, RandomAgentConfig
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib.simple_q import (ApexDQN, ApexDQNConfig, SimpleQ,
                                          SimpleQConfig)
from ray_tpu_torch.rllib.slateq import SlateDocEnv, SlateQ, SlateQConfig

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "SAC", "SACConfig",
           "Impala", "ImpalaConfig", "APPO", "APPOConfig", "A2C", "A2CConfig",
           "TD3", "TD3Config", "DDPG", "DDPGConfig", "CQL", "CQLConfig",
           "PG", "PGConfig",
           "BC", "BCConfig", "MARWIL", "MARWILConfig", "JsonReader",
           "write_offline_json", "ReplayBuffer", "PrioritizedReplayBuffer",
           "ModelSpec", "MODEL_REGISTRY", "get_model", "register_model",
           "Env", "CartPole", "Pendulum", "ENV_REGISTRY", "make_env",
           "Connector", "ConnectorPipeline", "FlattenObs", "NormalizeObs",
           "FrameStack", "ClipActions", "RescaleActions", "EnvRunner",
           "A3C", "A3CConfig", "ES", "ESConfig", "ARS", "ARSConfig",
           "SimpleQ", "SimpleQConfig", "ApexDQN", "ApexDQNConfig",
           "Bandit", "BanditConfig", "LinearDiscreteBandit",
           "CRR", "CRRConfig", "RandomAgent", "RandomAgentConfig",
           "DT", "DTConfig", "QMIX", "QMIXConfig", "CoopSwitch",
           "Rainbow", "RainbowConfig", "R2D2", "R2D2Config",
           "DreamerV3", "DreamerV3Config",
           "SequenceReplay", "MADDPG", "MADDPGConfig", "CoopNav",
           "AlphaZero", "AlphaZeroConfig", "MCTS", "TicTacToe",
           "SlateQ", "SlateQConfig", "SlateDocEnv",
           # The port's own names: the pixel and multi-agent envs (in the
           # reference's env.py, not its exports) and PPO's learner.
           "VisualCatch", "MultiAgentEnv", "DualCartPole", "PPOLearner",
           "make_ppo_loss"]
