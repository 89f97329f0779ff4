// API client for the lumen-tpu control plane (role of the reference's
// typed web-ui/src/lib/api.ts). Every path resolves through the GENERATED
// route manifest (api.generated.js, rebuilt from the live aiohttp app by
// scripts/generate_api_client.py and pinned by tests/test_web.py), so a
// server-side route rename breaks the client loudly instead of 404ing.
// Failures normalize to ApiError with a kind (network/permission/
// business/server) for errors.js to present.

import { ROUTES, fillPath } from "./api.generated.js";
import { ApiError } from "./errors.js";

async function call(routeName, { params, query, body } = {}) {
  const route = ROUTES[routeName];
  // A plain Error: this is a client-side programming bug (typo'd route
  // name), not a network condition — ApiError(null) would present it as
  // "control plane unreachable".
  if (!route) throw new Error(`unknown route: ${routeName}`);
  let path = fillPath(route.path, params || {});
  if (query) {
    const qs = new URLSearchParams(query).toString();
    if (qs) path += `?${qs}`;
  }
  const opts = { method: route.method, headers: {} };
  if (body !== undefined) {
    opts.headers["Content-Type"] = "application/json";
    opts.body = JSON.stringify(body);
  }
  let res;
  try {
    res = await fetch(path, opts);
  } catch (e) {
    throw new ApiError(`control plane unreachable: ${e.message}`, null);
  }
  const text = await res.text();
  let data = null;
  try {
    data = text ? JSON.parse(text) : null;
  } catch {
    data = { raw: text };
  }
  if (!res.ok) {
    throw new ApiError(
      (data && data.error) || `${route.method} ${path} -> HTTP ${res.status}`,
      res.status,
      data
    );
  }
  return data;
}

export const api = {
  health: () => call("health"),

  // hardware
  configLoad: (path) => call("config_load", { body: { path } }),
  serverLogs: () => call("server_logs"),
  hardwareInfo: () => call("hardware_info"),
  hardwareDetect: () => call("hardware_detect"),
  hardwareCheck: (cacheDir) =>
    // no client-side default: an absent param uses the server's default
    call("hardware_check", cacheDir ? { query: { cache_dir: cacheDir } } : {}),

  // config
  presets: () => call("config_presets"),
  /** @param {{preset: string, tier: string, region?: string, cache_dir?: string}} opts */
  generateConfig: (opts) => call("config_generate", { body: opts }),
  /** @returns {Promise<LumenConfig>} (typedef in api.generated.js) */
  currentConfig: () => call("config_current"),
  /** @param {LumenConfig} cfg @param {boolean=} loose */
  validateConfig: (cfg, loose) =>
    call("config_validate", { body: loose ? { config: cfg, loose: true } : { config: cfg } }),
  /** Validate editor YAML text as typed (per-field errors in the response). */
  validateConfigYaml: (yaml, loose) =>
    call("config_validate", { body: loose ? { yaml, loose: true } : { yaml } }),
  /** Reference SessionHub: is the deployment at config_path ready to start as-is? */
  sessionStatus: (configPath) =>
    call("session_status", { body: configPath ? { config_path: configPath } : {} }),
  /** Validate + persist edited YAML and make it the current config. */
  saveConfigYaml: (yaml, path, loose) =>
    call("config_save", { body: loose ? { yaml, path, loose: true } : { yaml, path } }),
  configYaml: async () => {
    const res = await fetch(ROUTES.config_yaml.path);
    if (!res.ok) throw new ApiError(`no config yet (HTTP ${res.status})`, res.status);
    return res.text();
  },

  // install
  installSetup: (opts) => call("install_setup", { body: opts }),
  installTasks: () => call("install_tasks"),
  installStatus: (id) => call("install_status", { params: { task_id: id } }),
  installLogs: (id, limit) =>
    call("install_logs", { params: { task_id: id }, query: limit ? { limit } : undefined }),
  installCancel: (id) => call("install_cancel", { params: { task_id: id } }),
  installCheckPath: (path) => call("install_check_path", { body: { path } }),

  // server
  serverStatus: () => call("server_status"),
  serverStart: (opts) => call("server_start", { body: opts || {} }),
  serverStop: () => call("server_stop"),
  serverRestart: () => call("server_restart"),
  metrics: async () => {
    const res = await fetch(ROUTES.metrics.path);
    return res.text();
  },
};

// Live log stream over /ws/logs (frames {type: connected|log|heartbeat}).
// Auto-reconnects with backoff; hands every log line to the subscribers.
export class LogStream {
  constructor() {
    this.subscribers = new Set();
    this.statusSubscribers = new Set();
    this.ws = null;
    this.backoff = 500;
    this.closed = false;
  }

  connect() {
    if (this.closed || (this.ws && this.ws.readyState <= 1)) return;
    const proto = location.protocol === "https:" ? "wss" : "ws";
    this.ws = new WebSocket(`${proto}://${location.host}/ws/logs`);
    this.ws.onopen = () => {
      this.backoff = 500;
      this._status(true);
    };
    this.ws.onmessage = (ev) => {
      let frame;
      try {
        frame = JSON.parse(ev.data);
      } catch {
        return;
      }
      if (frame.type === "log") {
        for (const fn of this.subscribers) fn(frame);
      }
    };
    this.ws.onclose = () => {
      this._status(false);
      if (!this.closed) {
        setTimeout(() => this.connect(), this.backoff);
        this.backoff = Math.min(this.backoff * 2, 8000);
      }
    };
    this.ws.onerror = () => this.ws && this.ws.close();
  }

  subscribe(fn) {
    this.subscribers.add(fn);
    this.connect();
    return () => this.subscribers.delete(fn);
  }

  onStatus(fn) {
    this.statusSubscribers.add(fn);
    return () => this.statusSubscribers.delete(fn);
  }

  _status(up) {
    for (const fn of this.statusSubscribers) fn(up);
  }

  close() {
    this.closed = true;
    if (this.ws) this.ws.close();
  }
}

export const logStream = new LogStream();
