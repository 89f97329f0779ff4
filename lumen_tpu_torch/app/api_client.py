"""Render the typed JS route manifest + typedefs the web wizard loads.

The port's counterpart of ``scripts/generate_api_client.py``: the single
source of truth is the port's own aiohttp app. :func:`collect_routes`
enumerates ``build_app()``'s registered routes into a ``ROUTES`` manifest,
and :func:`render_typedefs` renders the port's pydantic config schema
(``config_json_schema()``) into JSDoc ``@typedef`` blocks; :func:`render`
writes both as ``lumen_tpu_torch/app/web/js/api.generated.js``. The
hand-written ``api.js`` (copied byte for byte from the JAX package)
resolves every path through ``ROUTES``, so a route rename breaks the
client loudly, and ``tests/test_torch_web.py`` fails if the checked-in
file drifts from a fresh render.

Run: ``python -m lumen_tpu_torch.app.api_client`` (rewrites the file).
"""

from __future__ import annotations

import os
import sys

OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web", "js", "api.generated.js")

JS_TYPES = {
    "string": "string",
    "integer": "number",
    "number": "number",
    "boolean": "boolean",
    "null": "null",
    "object": "Object",
    "array": "Array",
}


def _js_type(prop: dict, defs: dict) -> str:
    """JSON-schema property -> JSDoc type expression (best effort; unions
    and unknown shapes degrade to broader types, never invalid JSDoc)."""
    if "$ref" in prop:
        return prop["$ref"].rsplit("/", 1)[-1]
    if "anyOf" in prop:
        parts = [_js_type(p, defs) for p in prop["anyOf"]]
        seen: list[str] = []
        for part in parts:
            if part not in seen:
                seen.append(part)
        return "(" + "|".join(seen) + ")" if len(seen) > 1 else seen[0]
    if "enum" in prop:
        return "|".join(
            f"{v!r}".replace("'", '"') if isinstance(v, str) else str(v)
            for v in prop["enum"]
        )
    t = prop.get("type")
    if t == "array":
        return f"{_js_type(prop.get('items', {}), defs)}[]"
    if t == "object" and "additionalProperties" in prop and isinstance(prop["additionalProperties"], dict):
        return f"Object<string, {_js_type(prop['additionalProperties'], defs)}>"
    return JS_TYPES.get(t, "*")


def render_typedefs() -> str:
    from ..core.config import config_json_schema

    schema = config_json_schema()
    defs = dict(schema.get("$defs", {}))
    defs[schema.get("title", "LumenConfig")] = schema
    blocks = []
    for name, model in defs.items():
        if model.get("type") != "object":
            continue
        required = set(model.get("required", []))
        lines = [f"/** @typedef {{Object}} {name}"]
        for prop_name, prop in model.get("properties", {}).items():
            opt = "" if prop_name in required else "="
            lines.append(f" * @property {{{_js_type(prop, defs)}{opt}}} {prop_name}")
        lines.append(" */")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def collect_routes() -> list[tuple[str, str, str]]:
    """-> sorted (name, method, path) from the real app's router."""
    from .api import build_app

    out = []
    for resource in build_app().router.resources():
        info = resource.get_info()
        path = info.get("path") or info.get("formatter")
        if path is None:  # static resource (the /ui asset mount)
            continue
        for route in resource:
            if route.method in ("HEAD", "OPTIONS"):
                continue
            name = route.handler.__name__
            out.append((name, route.method, path))
    return sorted(out)


def render() -> str:
    routes = collect_routes()
    lines = [
        "// GENERATED by lumen_tpu_torch/app/api_client.py — do not edit.",
        "// Route manifest + config typedefs derived from the live aiohttp app",
        "// and the pydantic schema (the reference generates its typed client",
        "// from the FastAPI OpenAPI schema the same way).",
        "",
        render_typedefs(),
        "",
        "/** Registered control-plane routes: name -> {method, path}.",
        " * Path params use {brace} placeholders; fill with fillPath(). */",
        "export const ROUTES = {",
    ]
    for name, method, path in routes:
        lines.append(f'  {name}: {{ method: "{method}", path: "{path}" }},')
    lines += [
        "};",
        "",
        "/** Fill {params} in a route path: fillPath(ROUTES.install_status.path,",
        ' *  {task_id: "abc"}) -> "/api/v1/install/status/abc". Throws on a',
        " * missing param so a renamed placeholder cannot 404 silently. */",
        "export function fillPath(path, params = {}) {",
        '  const placeholder = new RegExp("\\\\{([^}]+)\\\\}", "g");',
        "  return path.replace(placeholder, (_, key) => {",
        "    if (!(key in params)) throw new Error(`missing path param: ${key}`);",
        "    return encodeURIComponent(params[key]);",
        "  });",
        "}",
        "",
    ]
    return "\n".join(lines)


def main() -> int:
    content = render()
    with open(OUT_PATH, "w", encoding="utf-8") as f:
        f.write(content)
    print(f"wrote {OUT_PATH} ({len(content.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
