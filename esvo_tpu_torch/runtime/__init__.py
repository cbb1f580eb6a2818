"""SystemConfig, MappingCycle, EsvoSystem and checkpoints."""
