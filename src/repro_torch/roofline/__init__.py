"""The roofline of a dry run (port of ``repro.roofline``): the three-term
report (``analysis``) and the op counter it reads (``op_costs``)."""
from repro_torch.roofline.analysis import HW_H100, Hardware, RooflineReport, roofline_from_trace
from repro_torch.roofline.op_costs import OpCosts, OpCounter, tensor_bytes

__all__ = ["HW_H100", "Hardware", "OpCosts", "OpCounter", "RooflineReport", "roofline_from_trace",
           "tensor_bytes"]
