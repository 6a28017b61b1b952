"""The paper's own architecture: [784, 2000, 2000, 2000, 2000] ReLU MLP
trained with Forward-Forward on MNIST (Hinton 2022 / PFF paper §5.1).
The port's own copy of ``repro.configs.ff_mlp``."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FFMLPConfig:
    layer_sizes: Tuple[int, ...] = (784, 2000, 2000, 2000, 2000)
    num_classes: int = 10
    theta: float = 2.0              # goodness threshold
    lr_ff: float = 0.01             # Adam lr for FF layers (paper §5.1)
    lr_softmax: float = 1e-4        # Adam lr for the softmax head
    batch_size: int = 64
    epochs: int = 100
    splits: int = 100               # chapters (paper: S=100)
    cooldown_after: float = 0.5     # lr cooldown after 50% of epochs
    neg_mode: str = "adaptive"      # adaptive | fixed | random
    classifier: str = "goodness"    # goodness | softmax | perf_opt_*
    goodness_fn: str = "sumsq"      # sumsq | perf_opt (Performance-Optimized)
    peer_w: float = 0.0             # Hinton's peer-normalization weight
    kernel_impl: str = "auto"       # "auto" or a name in the port's
    #                                 kernels.registry.ff_dense
    #                                 (cuda | ref; validated by api.serve)
    seed: int = 0


PAPER_MLP = FFMLPConfig()

# CIFAR-10 variant (paper §5.6): 32*32*3 inputs, same hidden stack.
PAPER_MLP_CIFAR = dataclasses.replace(PAPER_MLP, layer_sizes=(3072, 2000, 2000, 2000, 2000))
