"""The decoder-LM zoo of the port (``repro.models``' counterpart): plain
functions on tensors over a :class:`~repro_torch.models.lm.DecoderLM`
(an ``nn.Module`` tree of the reference's parameter layout). Slice 8.1
builds the dense block kinds; MLA, SSM and MoE blocks are ROADMAP queue 1
item 8.2."""
