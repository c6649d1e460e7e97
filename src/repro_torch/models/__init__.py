"""Model layers and the language model of the serving slice."""
