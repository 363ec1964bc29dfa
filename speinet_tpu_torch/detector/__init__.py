"""Sharpness detector: focus features of frames and the logistic classifier
that labels them sharp (1) or blurry (0) when a video has no labels."""
