"""What one rank of the port's ``Dist`` steps holds on the reference's
production mesh ``pod1`` (data 16, model 16), for every applicable
(config, input shape): the bytes of its arguments
(``launch.dryrun.argument_bytes``: ``_rank_args`` on fake tensors inside
a fake process group, no trace) equal the bytes of rank 0's blocks under
the reference's rules (``per_device_argument_bytes``): its params and
Adam state by ``param_specs``, its rows of the train batch (the stub
embeddings too), its blocks of the decode caches by
``cache_specs_tree`` (the kv heads or, at batch 1, the sequence over
"model"; an SSM state's hd, or its heads at batch 1).
"""
import pytest

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun

COMBOS = dryrun.all_combos()
# a rank's arguments in GiB, the reference rules' blocks
EXAMPLES = {("llama-3.2-vision-90b", "train_4k"): 4.514,
            ("h2o-danube-3-4b", "long_500k"): 0.071,
            ("mamba2-780m", "decode_32k"): 0.048}


@pytest.mark.parametrize("arch,shape", COMBOS,
                         ids=[f"{a}-{s}" for a, s in COMBOS])
def test_a_ranks_arguments_are_the_rules_blocks(arch, shape):
    held, rules = dryrun.argument_bytes(get_config(arch),
                                        INPUT_SHAPES[shape], mesh="pod1")
    assert held == rules > 0
    if (arch, shape) in EXAMPLES:
        assert round(held / 2 ** 30, 3) == EXAMPLES[arch, shape]


def test_every_combo_is_checked():
    assert len(COMBOS) == 33 and set(EXAMPLES) <= set(COMBOS)
