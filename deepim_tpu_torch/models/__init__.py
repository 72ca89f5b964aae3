from deepim_tpu_torch.models.convert import state_dict_from_flax
from deepim_tpu_torch.models.flownet import FlowNetDeepIM, assemble_input, fixed_bilinear_upsample

__all__ = ["FlowNetDeepIM", "assemble_input", "fixed_bilinear_upsample", "state_dict_from_flax"]
