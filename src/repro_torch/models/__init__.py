"""Model zoo of the port: ``api.Model``/``api.build_model`` over the
attention family (``lm``) and its plain attention (``attention``)."""
