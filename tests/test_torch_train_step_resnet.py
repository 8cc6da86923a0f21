"""The train-step cases of ``tests/test_torch_train_step.py`` on a ResNet-50
trunk with the per-RoI conv5 head (``roi_conv5``, stem and stage 2 frozen),
5-stage, one image and a batch of two, in a file of their own so that this
architecture's JAX gradient compiles on another worker.  Method and
tolerances are stated there: float64 on both sides, losses within 1e-6,
every gradient leaf within 1e-4 of its max, parameters after the step
within 1e-6, sampled RoIs and labels identical.  The JAX tree's FrozenBN
leaves are drawn at random before it is bridged (zero-gamma would hide every
block's convolutions).
"""

from tests.test_torch_train_step import (  # noqa: F401  (collected here)
    case_fixture,
    test_gradient_leaves_match,
    test_losses_match,
    test_parameters_after_one_step_match,
    test_sampled_rois_and_labels_identical,
)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

case = case_fixture(5, trunk="resnet50", roi_conv5=True)
