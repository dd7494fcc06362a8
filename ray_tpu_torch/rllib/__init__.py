"""ray_tpu_torch.rllib — reinforcement learning (ray parity: rllib/).

The learner runs on the CUDA card (``num_gpus_per_learner``, default 1;
0 learns on the CPU), the env runners on CPUs. The offline algorithms
(BC, MARWIL, CQL, DT) and DreamerV3 learn in the driver; DT attends
through the port's flash kernels.
"""

from ray_tpu_torch.rllib.algorithm import (
    A2C,
    A2CConfig,
    APPO,
    APPOConfig,
    DQN,
    DQNConfig,
    IMPALA,
    IMPALAConfig,
    PG,
    PGConfig,
    PPO,
    PPOConfig,
    SAC,
    SACConfig,
    TD3,
    TD3Config,
    DDPG,
    DDPGConfig,
    Algorithm,
    AlgorithmConfig,
)
from ray_tpu_torch.rllib.env import CartPole, Reacher1D, make_env, register_env
from ray_tpu_torch.rllib.env_runner import ContinuousEnvRunner, EnvRunner
from ray_tpu_torch.rllib.evolution import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.learner import (
    A2CLearner,
    APPOLearner,
    DQNLearner,
    ImpalaLearner,
    Learner,
    PGLearner,
    PPOLearner,
    SACLearner,
    TD3Learner,
    vtrace,
)
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.external_env import PolicyClient, PolicyServerRunner
from ray_tpu_torch.rllib.dt import DT, DTConfig
from ray_tpu_torch.rllib.qmix import QMIX, QMIXConfig, TwoStepCoopGame
from ray_tpu_torch.rllib.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rllib.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    n_step_transform,
)
from ray_tpu_torch.rllib.rl_module import ContinuousRLModule, RLModule
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentCartPole,
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
)
from ray_tpu_torch.rllib.offline import (
    BC,
    BCConfig,
    BCLearner,
    CQL,
    CQLConfig,
    CQLLearner,
    MARWIL,
    MARWILConfig,
    MARWILLearner,
    read_json,
    write_json,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae

__all__ = [
    "A2C",
    "A2CConfig",
    "A2CLearner",
    "ARS",
    "ARSConfig",
    "APPO",
    "APPOConfig",
    "APPOLearner",
    "ContinuousEnvRunner",
    "ContinuousRLModule",
    "DDPG",
    "DDPGConfig",
    "Reacher1D",
    "TD3",
    "TD3Config",
    "TD3Learner",
    "Algorithm",
    "AlgorithmConfig",
    "CartPole",
    "DQN",
    "DQNConfig",
    "PolicyClient",
    "PolicyServerRunner",
    "DQNLearner",
    "DT",
    "DTConfig",
    "DreamerV3",
    "DreamerV3Config",
    "QMIX",
    "QMIXConfig",
    "R2D2",
    "R2D2Config",
    "TwoStepCoopGame",
    "BC",
    "BCConfig",
    "BCLearner",
    "CQL",
    "CQLConfig",
    "CQLLearner",
    "MARWIL",
    "MARWILConfig",
    "MARWILLearner",
    "read_json",
    "write_json",
    "EnvRunner",
    "IMPALA",
    "IMPALAConfig",
    "ImpalaLearner",
    "ES",
    "ESConfig",
    "PG",
    "PGConfig",
    "PGLearner",
    "Learner",
    "MultiAgentCartPole",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PrioritizedReplayBuffer",
    "RLModule",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "SACLearner",
    "SampleBatch",
    "compute_gae",
    "make_env",
    "n_step_transform",
    "register_env",
    "vtrace",
]
