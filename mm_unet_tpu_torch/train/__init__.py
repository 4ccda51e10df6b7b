"""Serving stack: DiceFocal loss, sliding-window inference, the predictor."""
