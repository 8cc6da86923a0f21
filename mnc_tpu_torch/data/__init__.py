"""Datasets of the port: the synthetic shapes generator and imdb, the
imdb base class and factory, and the mAP^r evaluator."""
