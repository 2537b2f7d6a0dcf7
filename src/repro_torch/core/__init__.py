"""Low-rank decomposition core of the PyTorch port: policies, SVD and
Tucker-2 decomposition, rank optimisation (Algorithm 1), sequential
freezing (Algorithm 2) and in-training rank adaptation."""

from repro_torch.core import (decompose, freezing, policy, rank_adapt,  # noqa: F401
                              rank_opt, svd, tucker)
from repro_torch.core.decompose import Decomposer, DecompositionPlan, apply_lrd  # noqa: F401
from repro_torch.core.freezing import (FreezeMode, apply_freeze, freeze_mask,  # noqa: F401
                                       merge, partition, phase_for_epoch)
from repro_torch.core.policy import (LM_DEFAULT, NO_LRD, RESNET_DEFAULT,  # noqa: F401
                                     DecompositionPolicy)
from repro_torch.core.rank_adapt import RankSchedule, schedule_from_config  # noqa: F401
from repro_torch.core.rank_opt import (TPU_V5E, HardwareModel, optimize_rank,  # noqa: F401
                                       optimize_rank_tucker, quantize_rank)
