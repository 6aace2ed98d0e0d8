"""Physics leaves, design spaces, the transient engine and the sweep."""
