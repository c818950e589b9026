"""Model assembly for the LM substrate: layers, attention, the Mamba2
SSD block and the transformer families the port runs."""
