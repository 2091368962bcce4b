"""Multi-device and multi-process execution of mode ``mut``: device lists,
sharded binning and EM, the merge of per-process histograms."""
