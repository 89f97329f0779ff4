// GENERATED by lumen_tpu_torch/app/api_client.py — do not edit.
// Route manifest + config typedefs derived from the live aiohttp app
// and the pydantic schema (the reference generates its typed client
// from the FastAPI OpenAPI schema the same way).

/** @typedef {Object} BackendSettings
 * @property {(string|null)=} device
 * @property {number=} batch_size
 * @property {(*[]|null)=} onnx_providers
 * @property {"bfloat16"|"float32"|"float16"=} dtype
 * @property {(MeshConfig|null)=} mesh
 * @property {number=} max_batch_latency_ms
 * @property {(number[]|null)=} batch_buckets
 * @property {boolean=} warmup
 * @property {"coalesce"|"continuous"=} scheduler
 * @property {number=} decode_block
 * @property {(string|null)=} quantize
 */

/** @typedef {Object} Deployment
 * @property {"single"|"hub"} mode
 * @property {(string|null)=} service
 * @property {(string[]|null)=} services
 */

/** @typedef {Object} ImportInfo
 * @property {string} registry_class
 * @property {string=} add_to_server
 */

/** @typedef {Object} Mdns
 * @property {boolean=} enabled
 * @property {(string|null)=} service_name
 */

/** @typedef {Object} MeshConfig
 * @property {Object<string, number>=} axes
 */

/** @typedef {Object} Metadata
 * @property {string} version
 * @property {"cn"|"other"} region
 * @property {string} cache_dir
 */

/** @typedef {Object} ModelConfig
 * @property {string} model
 * @property {"jax"|"torch"|"onnx"|"rknn"=} runtime
 * @property {(string|null)=} rknn_device
 * @property {(string|null)=} dataset
 * @property {(string|null)=} precision
 */

/** @typedef {Object} Server
 * @property {number} port
 * @property {string=} host
 * @property {(Mdns|null)=} mdns
 */

/** @typedef {Object} ServiceConfig
 * @property {boolean} enabled
 * @property {string} package
 * @property {ImportInfo} import_info
 * @property {BackendSettings=} backend_settings
 * @property {Object<string, ModelConfig>} models
 */

/** @typedef {Object} LumenConfig
 * @property {Metadata} metadata
 * @property {Deployment} deployment
 * @property {Server} server
 * @property {Object<string, ServiceConfig>} services
 */

/** Registered control-plane routes: name -> {method, path}.
 * Path params use {brace} placeholders; fill with fillPath(). */
export const ROUTES = {
  config_current: { method: "GET", path: "/api/v1/config/current" },
  config_generate: { method: "POST", path: "/api/v1/config/generate" },
  config_load: { method: "POST", path: "/api/v1/config/load" },
  config_presets: { method: "GET", path: "/api/v1/config/presets" },
  config_save: { method: "POST", path: "/api/v1/config/save" },
  config_validate: { method: "POST", path: "/api/v1/config/validate" },
  config_validate_path: { method: "POST", path: "/api/v1/config/validate-path" },
  config_yaml: { method: "GET", path: "/api/v1/config/yaml" },
  hardware_check: { method: "GET", path: "/api/v1/hardware/check" },
  hardware_detect: { method: "GET", path: "/api/v1/hardware/detect" },
  hardware_info: { method: "GET", path: "/api/v1/hardware/info" },
  health: { method: "GET", path: "/health" },
  index: { method: "GET", path: "/" },
  install_cancel: { method: "POST", path: "/api/v1/install/cancel/{task_id}" },
  install_check_path: { method: "POST", path: "/api/v1/install/check-path" },
  install_logs: { method: "GET", path: "/api/v1/install/logs/{task_id}" },
  install_setup: { method: "POST", path: "/api/v1/install/setup" },
  install_status: { method: "GET", path: "/api/v1/install/status/{task_id}" },
  install_tasks: { method: "GET", path: "/api/v1/install/tasks" },
  metrics: { method: "GET", path: "/api/v1/metrics" },
  server_logs: { method: "GET", path: "/api/v1/server/logs" },
  server_restart: { method: "POST", path: "/api/v1/server/restart" },
  server_start: { method: "POST", path: "/api/v1/server/start" },
  server_status: { method: "GET", path: "/api/v1/server/status" },
  server_stop: { method: "POST", path: "/api/v1/server/stop" },
  session_status: { method: "POST", path: "/api/v1/session/status" },
  ws_logs: { method: "GET", path: "/ws/logs" },
};

/** Fill {params} in a route path: fillPath(ROUTES.install_status.path,
 *  {task_id: "abc"}) -> "/api/v1/install/status/abc". Throws on a
 * missing param so a renamed placeholder cannot 404 silently. */
export function fillPath(path, params = {}) {
  const placeholder = new RegExp("\\{([^}]+)\\}", "g");
  return path.replace(placeholder, (_, key) => {
    if (!(key in params)) throw new Error(`missing path param: ${key}`);
    return encodeURIComponent(params[key]);
  });
}
