"""VGG-16 trunk, cascade heads and the MNC assembly."""
