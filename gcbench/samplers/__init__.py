"""Samplers of train traffic, one module a sampler, found by the traffic
file's ``sampler`` (``gcbench.inputs.sampler``)."""
