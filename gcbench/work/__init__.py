"""The work the benchmark counts itself, on its own reference and from
the cells' inputs, so that a later change of the program is read against
the same work: model FLOPs (``flops``), SubMConv neighbour pairs and
bytes (``flops.SubMConvWork``), kernel K1's operations and bytes
(``k1``), and the card's peaks (``peaks``)."""
