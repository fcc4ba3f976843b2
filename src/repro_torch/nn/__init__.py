"""The LM side stack: configs, parameter descriptors, layers, MoE, Mamba
and the composable transformer (the reference's `repro.nn`)."""
