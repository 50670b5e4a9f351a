"""Operation and byte counts of the kernels the benchmark reads a roofline share of,
from the configuration's shapes, and the card's published peaks."""
