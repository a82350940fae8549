"""Static analysis of lowered modules: the CFG and the per-block
divergence scores that lane compaction reads."""
