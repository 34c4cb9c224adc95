"""The HTTP serving layer over the port's facade (counterpart of
``gsv_tts_tpu/serving``).

The routes' logic is plain ``async`` methods that take a dict and return a
:class:`server.Reply`; only the app builders (``server.create_app``,
``webui.create_webui_app``, ``openai_compat.add_openai_routes`` through
``create_app``, ``realtime.create_realtime_app``) and ``router`` import
``aiohttp``, so every other module imports on a host without it."""
