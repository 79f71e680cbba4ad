"""Problem models: compiled constraint systems and block decompositions."""
