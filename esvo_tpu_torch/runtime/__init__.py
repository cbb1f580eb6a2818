"""The mapping-cycle configuration and MappingCycle."""
