"""The decoder-LM zoo of the port (``repro.models``' counterpart): plain
functions on tensors over a :class:`~repro_torch.models.lm.DecoderLM`
(an ``nn.Module`` tree of the reference's parameter layout): every block
kind of the registry (GQA and MLA attention, Mamba-2's SSD, Griffin's
RG-LRU) and FFN (dense, the single-device MoE and the expert-parallel
MoE of ``models.moe_ep``)."""
