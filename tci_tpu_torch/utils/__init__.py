"""L0 utilities: misc helpers, bidirectional index sets, sweep strategies."""
